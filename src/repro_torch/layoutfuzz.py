"""Seeded layout-fuzz generators for the native-layout differential tier.

A copy of the JAX package's test helper ``tests/layoutfuzz.py`` over the
port's own ``ContractionSpec``, so ``chip_smoke.py`` and the port's tests
draw the identical stream without importing the JAX package.  The arrays
are numpy; :func:`repro_torch.interop.from_numpy` hands them to the port
with their strides (reversed views are copied at that boundary).

The native SB-GEMM's claim is *layout obliviousness*: any mode ordering,
any storage layout of the operands, one kernel, zero copies.  The
generators here exercise exactly the axes that claim can fail on:

* **spec shape** — fully permuted mode orders (including the paper's
  exceptional no-first-mode cases), degenerate specs with zero free
  modes on either side (matvec / outer-product / scalar shapes),
  Hadamard-style shared batch modes, rank 1–5 operands;
* **mode extents** — dims 1–6 *including size-1 modes*, so tile clamps
  and padded extents are hit constantly;
* **operand storage** — each operand is materialised through a random
  numpy *layout treatment*: a contiguous buffer, a strided slice of a
  larger buffer, a negative-stride (reversed-axis) view, a
  transposed-storage view, or a stride-0 broadcast of a collapsed axis.
  The logical values are identical either way; the treatment controls
  the memory the arrays arrive from.

Operands are **integer-valued float32** drawn from a small range: every
product and partial sum in these dims is exactly representable, so any
reduction order gives the bit-identical result — the differential tests
assert ``np.array_equal`` against an einsum oracle, not allclose.  A
single flipped tile origin, dropped k-step, or mis-addressed mode shows
up as a hard bit difference, never hides inside a tolerance.

No hypothesis dependency: plain ``numpy.random.default_rng`` with fixed
seeds, so every failure is a deterministic repro.
"""

import numpy as np

from repro_torch.core.notation import ContractionSpec

SEED = 20260801
LAYOUT_STREAM = 77_000  # rng stream offset: disjoint from the other tiers

#: storage-layout treatments an operand may arrive through.
TREATMENTS = ("plain", "slice", "reverse", "transpose", "broadcast")


def gen_layout_spec(rng) -> tuple[ContractionSpec, dict]:
    """One random valid pairwise spec, biased toward layout edge cases.

    Unlike ``gen_pairwise`` (orders 2–5, free modes on both sides), this
    generator admits rank-1 operands, zero free modes (degenerate
    planner paths), zero contracted modes (outer products), and size-1
    extents — the shapes the native kernel must absorb without a copy.
    """
    letters = "abcdefghij"
    while True:
        n_k = int(rng.integers(0, 3))    # contracted modes (0 = outer)
        n_b = int(rng.integers(0, 3))    # shared batch modes
        n_af = int(rng.integers(0, 3))   # A's free modes
        n_bf = int(rng.integers(0, 3))   # B's free modes
        ra, rb = n_af + n_k + n_b, n_bf + n_k + n_b
        rc = n_af + n_bf + n_b
        if not (1 <= ra <= 5 and 1 <= rb <= 5 and rc <= 5):
            continue
        ms = list(letters[: n_k + n_b + n_af + n_bf])
        k = ms[:n_k]
        b = ms[n_k:n_k + n_b]
        af = ms[n_k + n_b:n_k + n_b + n_af]
        bf = ms[n_k + n_b + n_af:]
        a_modes = "".join(rng.permutation(af + k + b))
        b_modes = "".join(rng.permutation(bf + k + b))
        c_modes = "".join(rng.permutation(af + bf + b))
        cs = ContractionSpec(a_modes, b_modes, c_modes)
        try:
            cs.validate()
        except ValueError:
            continue
        # dims 1..6 with size-1 modes common enough to matter
        dims = {m: int(rng.integers(1, 7)) for m in ms}
        return cs, dims


def int_values(rng, shape) -> np.ndarray:
    """Integer-valued f32 operand: exact under any reduction order."""
    return rng.integers(-4, 5, size=shape).astype(np.float32)


def apply_treatment(rng, shape, treatment: str) -> np.ndarray:
    """Materialise an operand of ``shape`` through a storage layout.

    Returns a numpy view whose *logical* shape is ``shape`` but whose
    backing memory follows the treatment (strided / reversed /
    transposed / broadcast).  ``plain`` is the contiguous control.
    """
    shape = tuple(shape)
    if treatment == "plain" or not shape:
        return int_values(rng, shape)
    if treatment == "slice":  # strided window of a larger buffer
        ax = int(rng.integers(0, len(shape)))
        big = list(shape)
        step = int(rng.integers(2, 4))
        big[ax] = shape[ax] * step + int(rng.integers(0, 3))
        buf = int_values(rng, big)
        idx = [slice(None)] * len(shape)
        idx[ax] = slice(0, shape[ax] * step, step)
        view = buf[tuple(idx)]
    elif treatment == "reverse":  # negative stride on one axis
        ax = int(rng.integers(0, len(shape)))
        buf = int_values(rng, shape)
        idx = [slice(None)] * len(shape)
        idx[ax] = slice(None, None, -1)
        view = buf[tuple(idx)]
    elif treatment == "transpose":  # stored under a permuted axis order
        perm = tuple(rng.permutation(len(shape)))
        stored = int_values(rng, [shape[p] for p in perm])
        view = stored.transpose(tuple(np.argsort(perm)))
    elif treatment == "broadcast":  # stride-0 axis (repeated values)
        ax = int(rng.integers(0, len(shape)))
        collapsed = list(shape)
        collapsed[ax] = 1
        buf = int_values(rng, collapsed)
        view = np.broadcast_to(buf, shape)
    else:
        raise ValueError(f"unknown treatment {treatment!r}")
    assert view.shape == shape
    return view


def gen_layout_case(i: int):
    """Case ``i`` of the seeded layout-fuzz stream.

    Returns ``(cs, dims, A, B, treatments)`` where ``A``/``B`` are numpy
    arrays (possibly non-contiguous views) of the operand shapes.
    """
    rng = np.random.default_rng([SEED, LAYOUT_STREAM + i])
    cs, dims = gen_layout_spec(rng)
    t_a = TREATMENTS[int(rng.integers(0, len(TREATMENTS)))]
    t_b = TREATMENTS[int(rng.integers(0, len(TREATMENTS)))]
    A = apply_treatment(rng, [dims[m] for m in cs.a_modes], t_a)
    B = apply_treatment(rng, [dims[m] for m in cs.b_modes], t_b)
    return cs, dims, A, B, (t_a, t_b)
