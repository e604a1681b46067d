"""Hand-written Hopper kernels of the port and their launch wrappers.

Each kernel is CUDA C++ under ``csrc/``, built on first use by
:mod:`._build`, with its plain PyTorch version beside it:

- :mod:`.sb_gemm`: the native-layout StridedBatchedGEMM kernel;
  :mod:`.ops` and :mod:`.ext_gemm` drive it from planner output;
- :mod:`.grouped_gemm`: ragged per-group GEMMs in one launch, driven by
  :func:`.ops.grouped_matmul`;
- :mod:`.flash_attn`: forward attention with an online softmax.

Options kept only for the JAX package's signatures, which set TPU tiles
there and change nothing on the card: ``grouped_gemm(grid_dims=,
tiles=)`` (checked to cover every descriptor row; the kernel launches one
block per output tile of each group) and ``flash_attention(blocks=)``
(checked; the kernel's tile is fixed).  ``grouped_matmul(tiles=)`` is not
among them: it sets the packing, as in JAX.
"""

from repro_torch.kernels.ops import grouped_matmul  # noqa: F401 (public re-export)
