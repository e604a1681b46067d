"""Hand-written Hopper kernels of the port and their launch wrappers.

Each kernel is CUDA C++ under ``csrc/``, built on first use by
:mod:`._build`, with its plain PyTorch version beside it:

- :mod:`.sb_gemm`: the native-layout StridedBatchedGEMM kernel;
  :mod:`.ops` and :mod:`.ext_gemm` drive it from planner output;
- :mod:`.grouped_gemm`: ragged per-group GEMMs in one launch, driven by
  :func:`.ops.grouped_matmul`, on two routes (``wgmma`` for bf16 whose
  groups' depths are multiples of 64, ``fma`` otherwise);
- :mod:`.flash_attn`: forward attention with an online softmax, on two
  routes (``wgmma`` for bf16 that TMA can read, ``fma`` otherwise).

The two ``wgmma`` routes share the Hopper helpers of ``csrc/hopper.cuh``.
No wrapper keeps an option only for the JAX package's signature: the TPU
tiles and grids it set (``grouped_gemm(grid_dims=, tiles=)``,
``flash_attention(blocks=)``) have no counterpart on the card.
``grouped_matmul(tiles=)`` stays: it sets the packing, as in JAX.
"""

from repro_torch.kernels.ops import grouped_matmul  # noqa: F401 (public re-export)
