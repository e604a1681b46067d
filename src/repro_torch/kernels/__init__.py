"""Hand-written Hopper kernels of the port and their launch wrappers.

:mod:`.sb_gemm` holds the native-layout StridedBatchedGEMM kernel (CUDA
C++ in ``csrc/sb_gemm.cu``, built on first use by :mod:`._build`);
:mod:`.ops` and :mod:`.ext_gemm` drive it from planner output.
"""
