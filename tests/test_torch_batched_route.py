"""Contracted-mode fusion and the ``batched`` route of ``native_gemm``.

``native_plan`` reads only dtypes, extents, strides and alignment, so the
launch plans of every bf16 product the models send through ``native_gemm``
are pinned here on meta tensors at published widths: the attention scores
and P·V and their backward products at minicpm-2b's, qwen2-moe-a2.7b's
and internlm2-20b's head layouts (training, a prefill chunk, a decode
step), the a2a expert products and their backward at C2 341, GShard's
expert products, and the dense weight gradients whose contracted modes
``b`` and ``s`` fuse.  Each test checks the route, the fused contraction
(``k_modes``, innermost first, and K), the grid modes and the outer
contracted modes.  Each plan is then evaluated on the CPU through its own
addressing (``plan_emulation``: ``as_strided`` at every grid and outer
index, then a matmul per split) and must equal ``native_gemm_ref`` bit for
bit on integer-valued bf16 operands, so an addressing fault shows before
the card.  Batched and fused-K products are held against the JAX
package's ``native_gemm_pallas`` (in interpret mode) on the same numpy
operands.  The CUDA kernel itself runs in the ``gpu``-marked tests at the
end and in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.sb_gemm import (
    WGMMA_MAX_EXTRA, WGMMA_TM, WGMMA_TM_WIDE, native_gemm, native_gemm_ref, native_plan,
    wgmma_plan)

from plan_emulation import emulate

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _modes(spec):
    a, rest = spec.split(",")
    b, c = rest.split("->")
    return dict(a_modes=a, b_modes=b, c_modes=c)


def _meta(*shape):
    return torch.empty(*shape, dtype=BF16, device="meta")


# ------------------------------------------------------------- the path specs
def _attention(B, S, T, G, R, D):
    """The six attention products of one layout, each with its operands'
    shapes (all contiguous, as the model and autograd give them): the
    scores and P·V (``models/layers.py``) and each one's two backward
    products (``ops._NativeContraction``: ``(c,b)->a`` and ``(c,a)->b``)."""
    q, k, p, o = (B, S, G, R, D), (B, T, G, D), (B, G, R, S, T), (B, S, G, R, D)
    return {"scores": ("bsgrd,btgd->bgrst", q, k),
            "dq": ("bgrst,btgd->bsgrd", p, k),
            "dk": ("bgrst,bsgrd->btgd", p, q),
            "pv": ("bgrst,btgd->bsgrd", p, k),
            "dp": ("bsgrd,btgd->bgrst", o, k),
            "dv": ("bsgrd,bgrst->btgd", o, p)}


#: head layouts: (B, S, T, G, R, D)
MINICPM_TRAIN = (4, 512, 512, 36, 1, 64)      # minicpm-2b, 4 x 512 tokens (MHA)
QWEN_TRAIN = (4, 512, 512, 16, 1, 128)        # qwen2-moe-a2.7b
INTERN_TRAIN = (4, 512, 512, 8, 6, 128)       # internlm2-20b, 48 heads over 8
INTERN_CHUNK = (1, 64, 512, 8, 6, 128)        # a 64-token prefill chunk, 512 cached
INTERN_DECODE = (4, 1, 512, 8, 6, 128)        # a decode step of 4 slots

#: (label, spec, shapes, route, k_modes, K, M, N, grid extents innermost in C
#: first, outer contracted extents)
ATTENTION_CASES = []
for name, layout in (("minicpm-train", MINICPM_TRAIN), ("qwen-train", QWEN_TRAIN),
                     ("intern-train", INTERN_TRAIN), ("intern-chunk", INTERN_CHUNK),
                     ("intern-decode", INTERN_DECODE)):
    B, S, T, G, R, D = layout
    batch = [e for e in (G, B) if e > 1]
    for prod, (spec, sa, sb) in _attention(*layout).items():
        if name in ("intern-chunk", "intern-decode") and prod not in ("scores", "pv"):
            continue                      # serving runs no backward
        if prod in ("scores", "dp"):      # n = t; rows s, or r in a decode step
            m, rest = (S, [R]) if S > 1 else (R, [])
            grid = [e for e in rest if e > 1] + batch
            want = ("batched", "d", D, m, T, grid, [])
        elif prod in ("dq", "pv"):        # n = d; rows s (or r), K = t
            m, rest = (S, [R]) if S > 1 else (R, [])
            grid = [e for e in rest if e > 1] + batch
            want = ("batched", "t", T, m, D, grid, [])
        else:                             # dk, dv: rows t, contract s; r (if any) does not
            # fuse with s (neighbours in other orders in A and B): an outer mode
            want = ("batched", "s", S, T, D, batch, [R] if R > 1 else [])
        ATTENTION_CASES.append((f"{name}-{prod}", spec, (sa, sb), *want))

C2 = 341        # qwen2-moe-a2.7b's a2a rows per expert at 4096 tokens, one rank
X, E, F = 60, 2048, 1408
#: the expert products of ``distributed/moe_a2a.py`` and their backward,
#: GShard's (``models/moe.py``, group 4 of capacity 80: g and c fuse), and
#: the dense weight gradients (minicpm-2b: d_model 2304, d_ff 5760, vocab
#: 122880; 4 x 512 tokens)
OTHER_CASES = [
    ("expert-up", "xce,xef->xcf", ((X, C2, E), (X, E, F)), "batched", "e", E, C2, F, [X], []),
    ("expert-down", "xcf,xfe->xce", ((X, C2, F), (X, F, E)), "batched", "f", F, C2, E, [X], []),
    ("expert-up-dx", "xcf,xef->xce", ((X, C2, F), (X, E, F)), "batched", "f", F, C2, E, [X], []),
    ("expert-up-dw", "xcf,xce->xef", ((X, C2, F), (X, C2, E)), "batched", "c", C2, E, F, [X], []),
    ("expert-down-dx", "xce,xfe->xcf", ((X, C2, E), (X, F, E)), "batched", "e", E, C2, F, [X], []),
    ("expert-down-dw", "xce,xcf->xfe", ((X, C2, E), (X, C2, F)), "batched", "c", C2, F, E, [X], []),
    ("gshard-up", "xgce,xef->xgcf", ((X, 4, 80, E), (X, E, F)), "batched", "e", E, 320, F, [X], []),
    ("gshard-down", "xgcf,xfe->xgce", ((X, 4, 80, F), (X, F, E)), "batched", "f", F, 320, E,
     [X], []),
    ("head-dw", "bsv,bse->ve", ((4, 512, 122880), (4, 512, 2304)), "wgmma", "sb", 2048,
     122880, 2304, [], []),
    ("up-dw", "bsf,bse->ef", ((4, 512, 5760), (4, 512, 2304)), "wgmma", "sb", 2048, 2304,
     5760, [], []),
    ("down-dw", "bse,bsf->fe", ((4, 512, 2304), (4, 512, 5760)), "wgmma", "sb", 2048, 5760,
     2304, [], []),
    ("wo-dw", "bse,bsh->he", ((4, 512, 2304), (4, 512, 2304)), "wgmma", "sb", 2048, 2304,
     2304, [], []),
    ("wq-dw", "bsh,bse->eh", ((4, 512, 2304), (4, 512, 2304)), "wgmma", "sb", 2048, 2304,
     2304, [], []),
]

PLAN_CASES = ATTENTION_CASES + OTHER_CASES


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_path_spec_plan(case):
    """Route, fused contraction and grid modes of each path spec at its
    published widths."""
    label, spec, (sa, sb), route, k_modes, K, M, N, grid, outer = case
    got, plan = native_plan(_meta(*sa), _meta(*sb), **_modes(spec))
    assert got == route, label
    assert (plan["k_modes"], plan["K"], plan["M"], plan["N"]) == (k_modes, K, M, N)
    assert [g[0] for g in plan["grid"]] == grid
    assert [o[0] for o in plan["outer"]] == outer
    assert len(plan["grid"]) + len(plan["outer"]) <= WGMMA_MAX_EXTRA
    assert [g[3] for g in plan["grid"]] == sorted(g[3] for g in plan["grid"])
    assert (route == "wgmma") == (not grid and not outer)


def test_three_grid_modes_fill_a_rank_5_map():
    """internlm2-20b's training scores: r does not fuse with s (D apart in
    q, S·T in C), so b, g and r are grid modes: rank 5 for q's map, 4 for
    k's (k lacks r: its W stride is 0)."""
    spec, sa, sb = _attention(*INTERN_TRAIN)["scores"]
    _, plan = native_plan(_meta(*sa), _meta(*sb), **_modes(spec))
    assert [g[0] for g in plan["grid"]] == [6, 8, 4]
    assert [g[1] for g in plan["grid"]] == [128, 768, 512 * 8 * 6 * 128]   # q's strides
    assert [g[2] for g in plan["grid"]] == [0, 128, 512 * 8 * 128]         # k's strides
    assert (plan["xm"], plan["xk"], plan["wn"], plan["wk"]) == (8 * 6 * 128, 1, 8 * 128, 1)


def test_decode_rows_get_a_legal_stride():
    """A decode step of minicpm-2b (S = R = 1): X carries no row mode, so
    M = 1 and its map gets a legal row stride, as on the wgmma route."""
    spec, sa, sb = _attention(4, 1, 512, 36, 1, 64)["scores"]
    _, plan = native_plan(_meta(*sa), _meta(*sb), **_modes(spec))
    assert plan["M"] == 1 and plan["xk"] == 1 and plan["xm"] % 8 == 0 and plan["xm"] >= 64
    assert [g[0] for g in plan["grid"]] == [36, 4]


@pytest.mark.parametrize("why", ["start 8 bytes off", "rows 500 bytes apart",
                                 "four grid modes", "float32", "mixed bf16 x f32",
                                 "batch mode minor-most in C", "W carries a C mode",
                                 "broadcast grid mode"])
def test_batched_layouts_that_stay_generic(why):
    kw = _modes("xce,xef->xcf")
    A, B = torch.zeros(3, 40, 64, dtype=BF16), torch.zeros(3, 64, 48, dtype=BF16)
    if why == "start 8 bytes off":
        A = torch.zeros(3 * 40 * 64 + 4, dtype=BF16)[4:].view(3, 40, 64)
    elif why == "rows 500 bytes apart":
        A, B = torch.zeros(3, 40, 250, dtype=BF16), torch.zeros(3, 250, 48, dtype=BF16)
    elif why == "four grid modes":
        A, B, kw = (torch.zeros(2, 2, 2, 2, 16, 64, dtype=BF16),
                    torch.zeros(2, 2, 2, 2, 64, 48, dtype=BF16), _modes("abcdme,abcden->abcdmn"))
    elif why == "float32":
        A, B = A.float(), B.float()
    elif why == "mixed bf16 x f32":
        B = B.float()
    elif why == "batch mode minor-most in C":
        kw = _modes("xce,xef->cfx")
    elif why == "W carries a C mode":
        A, B, kw = torch.zeros(3, 64, dtype=BF16), torch.zeros(3, 64, 5, 48, dtype=BF16), \
            _modes("xe,xetf->xtf")
    elif why == "broadcast grid mode":       # W's expert stride 0
        B = torch.zeros(1, 64, 48, dtype=BF16).expand(3, 64, 48)
    # float32 and mixed products take fbatched; bf16 ones no tensor map
    # reads, which the retired generic route took, take gathered
    want = "fbatched" if why in ("float32", "mixed bf16 x f32") else "gathered"
    assert native_plan(A, B, **kw)[0] == want, why


#: a decode step's P·V at 1 to 16 slots (internlm2-20b's and minicpm-2b's
#: heads, one 1024-token attention chunk), and a prefill's or weight
#: gradient's products at 1 to 5000 rows
def _decode_pv(slots, G, R, D, T=1024):
    return native_plan(_meta(slots, G, R, 1, T), _meta(slots, T, G, D),
                       **_modes("bgrst,btgd->bsgrd"))[1]


@pytest.mark.parametrize("G,R,D", [(8, 6, 128), (36, 1, 64)], ids=["intern", "minicpm"])
def test_a_split_depends_on_the_product_alone(G, R, D):
    """A row's sums may not depend on what shares its launch: the other
    slots of a decode bucket, the other rows of a prefill chunk or of a
    whole prompt.  So a batched product (its grid grows with the slots)
    and a product with X M-major (a weight gradient) are never split, at
    any grid or row count; a K-major product with neither grid nor outer
    mode (weight streaming) splits by N and K alone."""
    for slots in (1, 2, 4, 16, 64):
        p = _decode_pv(slots, G, R, D)
        assert p["kind"] == "batched" and p["G"] == G * slots
        assert (p["n_split"], p["kc"], p["workspace"]) == (1, 1024, 0)
    rows = [native_plan(_meta(1, m, 2304), _meta(2304, 5760), **_modes("bse,ef->bsf"))[1]
            for m in (1, 4, 64, 65, 4096, 5000)]
    assert len({(p["n_split"], p["kc"]) for p in rows}) == 1 and rows[0]["n_split"] > 1
    for v in (64, 2304, 122880):               # dW: X M-major, at any rows
        p = native_plan(_meta(4, 512, v), _meta(4, 512, 2304), **_modes("bsv,bse->ve"))[1]
        assert p["kind"] == "wgmma" and p["xm"] == 1 and p["n_split"] == 1
    assert wgmma_plan(64, 128, 100000, split=False)["n_split"] == 1
    assert wgmma_plan(64, 128, 100000)["n_split"] > 1


def test_tile_rows_follow_m():
    """One kernel, two tile heights: 64 rows (one consumer warpgroup) up
    to 64 rows (weight streaming, decode), 128 above."""
    assert wgmma_plan(64, 128, 64)["tiles"] == 1 and wgmma_plan(65, 128, 64)["tiles"] == 1
    assert wgmma_plan(129, 128, 64)["tiles"] == 2
    assert wgmma_plan(341, 1408, 2048, G=60)["tiles"] == 60 * 3 * 11
    assert (WGMMA_TM, WGMMA_TM_WIDE) == (64, 128)


def test_batched_constants_mirror_the_cuda_source():
    """The wide tile and the limit on extra modes are the kernel's own
    #defines, and the descriptor packs to the C struct's size."""
    import re

    from repro_torch.kernels import _build, sb_gemm

    src = (_build.CSRC / "sb_gemm.cu").read_text()
    define = {m[1]: m[2] for m in re.finditer(r"#define (\w+) (.+?)(?:\s+//.*)?$", src,
                                              re.MULTILINE)}
    assert int(define["NM_TM_WIDE"]) == WGMMA_TM_WIDE
    assert int(define["NM_MAX_EXTRA"]) == WGMMA_MAX_EXTRA
    # int64 M, N, K, ext[3], xs[5], ws[5], cs[4]; int32 n_grid, n_extra, kc, n_split
    assert sb_gemm._NM_DESC.size == 20 * 8 + 4 * 4
    assert "NmDesc" in src and "NbDesc" not in src


# ------------------------------------------- the plans' addressing, bit-exact
def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32)).to(BF16)


#: the path specs at small widths (every stride a multiple of 16 bytes), a
#: 1024-deep decode P·V, the fused dW and a fused K-major product that
#: splits
SMALL = [(spec, shapes, f"{label}-small") for label, layout in
         (("minicpm", (2, 24, 40, 3, 1, 16)), ("intern", (2, 24, 40, 3, 2, 16)),
          ("decode", (2, 1, 40, 3, 2, 16)))
         for _, (spec, *shapes) in _attention(*layout).items()]
SMALL += [("bgrst,btgd->bsgrd", ((1, 2, 6, 1, 1024), (1, 1024, 2, 128)), "deep-pv"),
          ("xce,xef->xcf", ((3, 21, 32), (3, 32, 24)), "expert-up"),
          ("xcf,xfe->xce", ((3, 21, 24), (3, 24, 32)), "expert-down"),
          ("xcf,xce->xef", ((3, 21, 24), (3, 21, 32)), "expert-up-dw"),
          ("xce,xcf->xfe", ((3, 21, 32), (3, 21, 24)), "expert-down-dw"),
          ("xgce,xef->xgcf", ((3, 2, 8, 32), (3, 32, 24)), "gshard-up"),
          ("bsv,bse->ve", ((2, 24, 40), (2, 24, 16)), "head-dw"),
          ("bsf,bse->ef", ((2, 512, 200), (2, 512, 136)), "up-dw"),
          ("mbs,nbs->mn", ((136, 2, 512), (200, 2, 512)), "fused-split"),
          ("bse,bsf->fe", ((2, 24, 16), (2, 24, 5000)), "down-dw")]


@pytest.mark.parametrize("spec,shapes,label", SMALL, ids=[s[2] for s in SMALL])
@pytest.mark.parametrize("out_dtype", [BF16, torch.float32], ids=["bf16", "f32"])
def test_plan_addressing_is_bit_exact(spec, shapes, label, out_dtype):
    rng = np.random.default_rng(25)
    A, B = (_ints(rng, s) for s in shapes)
    modes = _modes(spec)
    route, plan = native_plan(A, B, **modes)
    assert route in ("batched", "wgmma"), label
    assert (plan["n_split"] > 1) == label.endswith("split")
    if label.startswith("intern") and spec.endswith("->btgd"):
        assert [o[0] for o in plan["outer"]] == [2]   # r beside s
    want = native_gemm_ref(A, B, out_dtype=out_dtype, **modes)
    got = emulate(plan, A, B, list(want.shape)).to(out_dtype)
    assert torch.equal(got, want), label


def test_emulation_sees_a_wrong_grid_stride():
    """The emulation is a real check: one grid stride off and it differs."""
    rng = np.random.default_rng(26)
    A, B = _ints(rng, (3, 21, 32)), _ints(rng, (3, 32, 24))
    modes = _modes("xce,xef->xcf")
    _, plan = native_plan(A, B, **modes)
    want = native_gemm_ref(A, B, **modes)
    ext, xs, ws, cs = plan["grid"][0]
    bad = dict(plan, grid=[(ext, xs, ws - 8, cs)])
    assert not torch.equal(emulate(bad, A, B, list(want.shape)).to(BF16), want)


def test_emulation_sees_a_wrong_outer_stride():
    rng = np.random.default_rng(26)
    A, B = _ints(rng, (2, 3, 2, 24, 40)), _ints(rng, (2, 24, 3, 2, 16))
    modes = _modes("bgrst,bsgrd->btgd")
    _, plan = native_plan(A, B, **modes)
    want = native_gemm_ref(A, B, **modes)
    (ext, xs, ws), = plan["outer"]
    bad = dict(plan, outer=[(ext, xs, ws - 8)])
    assert torch.equal(emulate(plan, A, B, list(want.shape)).to(BF16), want)
    assert not torch.equal(emulate(bad, A, B, list(want.shape)).to(BF16), want)


def test_cpu_batched_takes_the_plain_version_and_counts_no_route():
    rng = np.random.default_rng(27)
    A, B = _ints(rng, (3, 21, 32)), _ints(rng, (3, 32, 24))
    kw = _modes("xce,xef->xcf")
    assert native_plan(A, B, **kw)[0] == "batched"
    before = native_gemm.launches, dict(native_gemm.launches_by_route)
    got = native_gemm(A, B, **kw)
    assert torch.equal(got, native_gemm_ref(A, B, **kw)) and got.is_contiguous()
    assert (native_gemm.launches, native_gemm.launches_by_route) == before


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("spec,shapes", [
    ("bgrst,btgd->bsgrd", ((2, 3, 2, 24, 40), (2, 40, 3, 16))),     # batched, 3 grid modes
    ("bsv,bse->ve", ((2, 24, 40), (2, 24, 16))),                     # fused K = b·s
    ("bgrst,bsgrd->btgd", ((2, 3, 2, 24, 40), (2, 24, 3, 2, 16))),   # outer r beside s
], ids=["batched-pv", "fused-head-dw", "outer-dk"])
def test_native_gemm_matches_native_gemm_pallas(spec, shapes):
    """The port's ``native_gemm`` (its CPU path, the plain version) on the
    product the plan sends to ``batched`` (with grid or outer contracted
    modes) or fuses, against the JAX
    package's ``native_gemm_pallas`` in interpret mode (through its
    ``execute_native``) on the same bf16 numpy operands, f32 output.  The
    products of bf16 values are exact in f32; the two sum in other
    orders: 1e-5 of the largest magnitude."""
    import jax.numpy as jnp

    from repro.kernels.ops import execute_native

    rng = np.random.default_rng(28)
    An, Bn = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    A, B = (torch.from_numpy(x).to(BF16) for x in (An, Bn))
    modes = _modes(spec)
    assert native_plan(A, B, **modes)[0] in ("batched", "wgmma")
    got = native_gemm(A, B, out_dtype=torch.float32, **modes).numpy()
    want = np.asarray(execute_native(spec, jnp.asarray(A.float().numpy()).astype(jnp.bfloat16),
                                     jnp.asarray(B.float().numpy()).astype(jnp.bfloat16),
                                     out_dtype=jnp.float32, interpret=True))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# ------------------------------------------------------------------ the card
GPU_CASES = list(SMALL)
GPU_CASES += [("bsgrd,btgd->bgrst", ((2, 70, 3, 2, 64), (2, 136, 3, 64)), "ragged-scores"),
              ("xcf,xce->xef", ((3, 341, 200), (3, 341, 256)), "ragged-expert-dw"),
              ("bgrst,bsgrd->btgd", ((2, 3, 2, 70, 136), (2, 70, 3, 2, 64)), "ragged-outer-dk"),
              ("bsgrd,bgrst->btgd", ((2, 70, 3, 2, 64), (2, 3, 2, 70, 136)), "ragged-outer-dv")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.Generator(device="cuda").manual_seed(30)


@pytest.mark.gpu
@pytest.mark.parametrize("spec,shapes,label", GPU_CASES, ids=[c[2] for c in GPU_CASES])
def test_batched_and_fused_routes_on_the_card(spec, shapes, label):
    """Each case launches its route twice, bit-identical, and equals the
    plain version on integer-valued operands (exact sums)."""
    gen = _card()
    A, B = (torch.randint(-3, 4, s, generator=gen, device="cuda").to(BF16) for s in shapes)
    modes = _modes(spec)
    route = native_plan(A, B, **modes)[0]
    assert route in ("batched", "wgmma"), label
    before = native_gemm.launches_by_route[route]
    got, again = native_gemm(A, B, **modes), native_gemm(A, B, **modes)
    torch.cuda.synchronize()
    assert native_gemm.launches_by_route[route] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, native_gemm_ref(A, B, **modes))


@pytest.mark.gpu
@pytest.mark.parametrize("G,R,D", [(8, 6, 128), (36, 1, 64)], ids=["intern", "minicpm"])
def test_a_decode_slot_gets_the_same_bits_in_any_bucket(G, R, D):
    """A decode step's scores and P·V of one slot alone, and of the same
    slot in a bucket of 4 and of 16, on normal random operands: bit for
    bit the same (a 1024-token attention chunk)."""
    gen = _card()
    T = 1024
    q = torch.randn(16, 1, G, R, D, generator=gen, device="cuda").to(BF16)
    k = torch.randn(16, T, G, D, generator=gen, device="cuda").to(BF16)
    p = torch.randn(16, G, R, 1, T, generator=gen, device="cuda").to(BF16)
    scores, pv = _modes("bsgrd,btgd->bgrst"), _modes("bgrst,btgd->bsgrd")
    for slots in (1, 4, 16):
        assert native_plan(q[:slots], k[:slots], **scores)[0] == "batched"
    alone = native_gemm(q[:1], k[:1], **scores), native_gemm(p[:1], k[:1], **pv)
    for slots in (4, 16):
        bucket = (native_gemm(q[:slots], k[:slots], **scores),
                  native_gemm(p[:slots], k[:slots], **pv))
        for one, many in zip(alone, bucket):
            assert torch.equal(one, many[:1]), slots


@pytest.mark.gpu
def test_rows_get_the_same_bits_in_a_chunk_and_a_whole_prompt():
    """Rows of a 5000-row product on the wgmma route (a whole prompt past
    4096 tokens) and the same rows in a 64-row chunk and alone, on normal
    random operands: bit for bit the same, the split included."""
    gen = _card()
    x = torch.randn(1, 5000, 2048, generator=gen, device="cuda").to(BF16)
    w = torch.randn(2048, 1032, generator=gen, device="cuda").to(BF16)
    kw = _modes("bse,ef->bsf")
    plans = [native_plan(x[:, :m], w, **kw)[1] for m in (1, 64, 5000)]
    assert {p["n_split"] for p in plans} == {plans[0]["n_split"]} and plans[0]["n_split"] > 1
    whole = native_gemm(x, w, **kw)
    assert torch.equal(native_gemm(x[:, :64], w, **kw), whole[:, :64])
    assert torch.equal(native_gemm(x[:, 64:128], w, **kw), whole[:, 64:128])
    assert torch.equal(native_gemm(x[:, :1], w, **kw), whole[:, :1])
