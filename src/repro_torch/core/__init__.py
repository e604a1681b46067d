"""The contraction engine, ported to PyTorch:

:mod:`repro_torch.core.notation` — mode algebra and layout rules;
:mod:`repro_torch.core.planner`  — Algorithm 2 (pairwise plans) + cost model;
:mod:`repro_torch.core.contract` — pairwise execution on library GEMMs or
the hand-written kernel;
:mod:`repro_torch.core.einsum`   — the n-ary front-end with path planning;
:mod:`repro_torch.core.program`  — whole-expression contraction programs;
:mod:`repro_torch.core.passes`   — the program pass pipeline;
:mod:`repro_torch.core.tucker` and :mod:`repro_torch.core.cp` — the
decompositions built on it.

Submodules are imported directly (``from repro_torch.core.contract import
contract``); this package imports nothing at load time.
"""
