"""Hand-written Hopper kernels of the port and their launch wrappers.

Each kernel is CUDA C++ under ``csrc/``, built on first use by
:mod:`._build`, with its plain PyTorch version beside it:

- :mod:`.sb_gemm`: the native-layout StridedBatchedGEMM kernel;
  :mod:`.ops` and :mod:`.ext_gemm` drive it from planner output;
- :mod:`.grouped_gemm`: ragged per-group GEMMs in one launch, driven by
  :func:`.ops.grouped_matmul`;
- :mod:`.flash_attn`: forward attention with an online softmax, on two
  routes (``wgmma`` for bf16 that TMA can read, ``fma`` otherwise).

An option kept only for the JAX package's signature, which sets TPU tiles
there and changes nothing on the card: ``grouped_gemm(grid_dims=,
tiles=)`` (checked to cover every descriptor row; the kernel launches one
block per output tile of each group).  ``grouped_matmul(tiles=)`` is not
such an option: it sets the packing, as in JAX.
"""

from repro_torch.kernels.ops import grouped_matmul  # noqa: F401 (public re-export)
