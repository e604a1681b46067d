"""PyTorch/CUDA port of the contraction engine (the JAX package ``repro``
is the reference it is held against).

It imports ``torch`` and never ``jax``, nor anything of ``repro``.  Entry
points compute on their operands' device; what creates tensors defaults to
``cuda`` and takes ``device="cpu"`` for the CPU.  The hand-written kernels
launch on CUDA tensors; CPU tensors take their plain PyTorch versions.
"""
