"""The port's grouped GEMM (``kernels/grouped_gemm.py``, ``ops.grouped_matmul``)
against the JAX package's, on the same numpy inputs.

Every case of ``TestGroupedGemm`` in ``tests/test_runtime.py`` runs through
both packages at the JAX tests' tolerances.  On the CPU the port's wrapper
checks the whole launch (descriptor rows, tile list, bounds) and then takes
the plain version; the JAX package runs its Pallas kernel in interpret mode.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` and by the ``gpu``-marked test below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grouped_gemm as jgg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import grouped_matmul, ops, ref

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    """The JAX side compiles many programs here; drop them when the module
    ends, so later timing-sensitive tests in the same worker run as alone."""
    yield
    jax.clear_caches()


F32 = dict(rtol=1e-5, atol=1e-5)       # tests/test_runtime.py's f32 tolerance
BF16 = dict(rtol=2e-1, atol=2e-1)      # and its bf16 one
T8 = {"u": 8, "v": 8, "k": 8}


def _rand_groups(shapes, seed=0):
    rng = np.random.default_rng(seed)
    As = [rng.standard_normal((m, k)).astype(np.float32) for m, n, k in shapes]
    Bs = [rng.standard_normal((k, n)).astype(np.float32) for m, n, k in shapes]
    return As, Bs


def _both(As, Bs, jdtype=jnp.float32, tdtype=torch.float32):
    """The same numpy operands as JAX arrays and as CPU tensors."""
    jA = [jnp.asarray(a, jdtype) for a in As]
    jB = [jnp.asarray(b, jdtype) for b in Bs]
    tA = [t.to(tdtype) for t in interop.from_numpy(As, device="cpu")]
    tB = [t.to(tdtype) for t in interop.from_numpy(Bs, device="cpu")]
    return jA, jB, tA, tB


SHAPE_LISTS = [
    [(5, 17, 9), (12, 3, 33), (1, 1, 1), (40, 20, 8)],
    [(8, 8, 8)],
    [(3, 3, 3), (3, 3, 3), (3, 3, 3)],
    [(33, 7, 65), (2, 31, 4)],
]


@pytest.mark.parametrize("shapes", SHAPE_LISTS, ids=str)
def test_matches_jax(shapes):
    jA, jB, tA, tB = _both(*_rand_groups(shapes))
    want = jops.grouped_matmul(jA, jB, tiles=T8)
    got = grouped_matmul(tA, tB, tiles=T8)
    for o, w, (m, n, k) in zip(got, want, shapes):
        assert tuple(o.shape) == (m, n)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), **F32)
    for o, r in zip(got, gg.grouped_gemm_ref(tA, tB)):
        np.testing.assert_allclose(o.numpy(), r.numpy(), **F32)


def test_default_tiles_and_bf16_match_jax():
    shapes = [(5, 130, 9), (20, 4, 140)]
    jA, jB, tA, tB = _both(*_rand_groups(shapes), jnp.bfloat16, torch.bfloat16)
    want = jops.grouped_matmul(jA, jB)
    got = grouped_matmul(tA, tB)
    for o, w in zip(got, want):
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(o.float().numpy(), np.asarray(w, np.float32), **BF16)


@pytest.mark.parametrize("case", ["matches", "bf16", "padding", "single", "subtile",
                                  "empty", "trans"])
def test_pack_groups_equals_jax(case):
    """The descriptor table equals JAX's field by field, and the packed
    buffers have JAX's shapes and contents, for every case of this file."""
    rng = np.random.default_rng(21)
    ta = tb = False
    tiles = T8
    if case == "matches":
        As, Bs = _rand_groups(SHAPE_LISTS[0])
    elif case == "bf16":
        As, Bs = _rand_groups([(5, 130, 9), (20, 4, 140)])
        tiles = None
    elif case == "padding":
        As, Bs = _rand_groups([(256, 8, 8), (1, 8, 8)])
    elif case == "single":
        As, Bs = _rand_groups([(13, 29, 7)])
    elif case == "subtile":
        As, Bs = _rand_groups([(3, 5, 2), (1, 1, 1)])
        tiles = None
    elif case == "empty":
        As = [rng.standard_normal(s).astype(np.float32) for s in ((4, 0), (0, 6), (4, 6), (4, 6))]
        Bs = [rng.standard_normal(s).astype(np.float32) for s in ((0, 5), (6, 5), (6, 0), (6, 5))]
    else:
        As, Bs, ta, tb = _trans_case()
        tiles = None
    jA, jB, tA, tB = _both(As, Bs)
    jAf, jBf, jd, jp = jgg.pack_groups(jA, jB, tiles, trans_a=ta, trans_b=tb)
    tAf, tBf, td, tp = gg.pack_groups(tA, tB, tiles, trans_a=ta, trans_b=tb)
    assert td.dtype == torch.int32 and td.device.type == "cpu"
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert tuple(tAf.shape) == tuple(jAf.shape) and tuple(tBf.shape) == tuple(jBf.shape)
    assert np.array_equal(tAf.numpy(), np.asarray(jAf))
    assert np.array_equal(tBf.numpy(), np.asarray(jBf))
    assert [(p.m, p.n, p.k) for p in tp] == [(p.m, p.n, p.k) for p in jp]
    assert gg.DESC_FIELDS == jgg.DESC_FIELDS
    assert gg.GROUPED_DEFAULT_TILES == jgg.GROUPED_DEFAULT_TILES


@pytest.mark.parametrize("shapes,tiles", [
    (SHAPE_LISTS[0], T8),
    (SHAPE_LISTS[3], {"u": 8, "v": 32, "k": 32}),
    ([(5, 130, 9), (20, 4, 140)], None),
], ids=["t8", "t32", "default"])
def test_packed_ref_equals_pallas_on_jax_buffers(shapes, tiles):
    """The plain version of the packed function, fed JAX's own packed
    buffers and table, equals ``grouped_gemm_pallas`` wherever a group's
    block lies."""
    jA, jB, _, _ = _both(*_rand_groups(shapes, seed=5))
    A_flat, B_flat, descs, problems = jgg.pack_groups(jA, jB, tiles)
    eff = {**jgg.GROUPED_DEFAULT_TILES, **(tiles or {})}
    grid, out_rows, out_cols = gg.packed_geometry(problems, eff)
    want = np.asarray(jgg.grouped_gemm_pallas(
        A_flat, B_flat, descs, grid_dims=grid, tiles=eff, out_cols=out_cols,
        out_rows=out_rows))
    tA, tB, td = interop.from_numpy(
        (np.asarray(A_flat), np.asarray(B_flat), np.asarray(descs)), device="cpu")
    plain = gg.grouped_gemm_packed_ref(tA, tB, td, out_cols=out_cols, out_rows=out_rows)
    wrapped = gg.grouped_gemm(tA, tB, td, out_cols=out_cols, out_rows=out_rows)
    assert torch.equal(plain, wrapped)
    for m, n, _, _, _, c_off, _, _ in np.asarray(descs).tolist():
        np.testing.assert_allclose(plain[c_off:c_off + m, :n].numpy(),
                                   want[c_off:c_off + m, :n], **F32)


REJECTIONS = {
    "k mismatch": lambda A: grouped_matmul([A], [torch.zeros(5, 4)]),
    "no groups": lambda A: grouped_matmul([], []),
    "tile not a multiple of 8": lambda A: grouped_matmul([A], [A], tiles={"u": 7}),
    "unknown role": lambda A: grouped_matmul([A], [A], tiles={"b": 8}),
    "flag arity": lambda A: grouped_matmul([A], [A], trans_a=[True, False]),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejects_bad_groups_and_tiles(case):
    with pytest.raises(ValueError):
        REJECTIONS[case](torch.zeros(4, 4))


def test_single_group_matches_jax():
    jA, jB, tA, tB = _both(*_rand_groups([(13, 29, 7)]))
    (want,) = jops.grouped_matmul(jA, jB, tiles=T8)
    (got,) = grouped_matmul(tA, tB, tiles=T8)
    assert tuple(got.shape) == (13, 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    (r,) = ref.ref_grouped_gemm(tA, tB)
    np.testing.assert_allclose(got.numpy(), r.numpy(), **F32)


def test_all_sub_tile_group_matches_jax():
    jA, jB, tA, tB = _both(*_rand_groups([(3, 5, 2), (1, 1, 1)]))
    want = jops.grouped_matmul(jA, jB)
    got = grouped_matmul(tA, tB)
    for o, w in zip(got, want):
        assert tuple(o.shape) == tuple(w.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), **F32)


def test_empty_groups_match_jax():
    rng = np.random.default_rng(3)
    As = [rng.standard_normal(s).astype(np.float32) for s in ((4, 0), (0, 6), (4, 6), (4, 6))]
    Bs = [rng.standard_normal(s).astype(np.float32) for s in ((0, 5), (6, 5), (6, 0), (6, 5))]
    jA, jB, tA, tB = _both(As, Bs)
    want = jops.grouped_matmul(jA, jB, tiles=T8)
    got = grouped_matmul(tA, tB, tiles=T8)
    assert [tuple(o.shape) for o in got] == [(4, 5), (0, 5), (4, 0), (4, 5)]
    assert torch.all(got[0] == 0.0)      # k=0 → exact zeros
    for o, w in zip(got, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), **F32)
    (empty,) = grouped_matmul([torch.zeros(0, 0)], [torch.zeros(0, 0)])
    assert tuple(empty.shape) == (0, 0)


def _trans_case():
    rng = np.random.default_rng(7)

    def r(*s):
        return rng.integers(-3, 4, s).astype(np.float32)

    # group 0 plain; group 1 both stored transposed; group 2 A only
    As = [r(5, 7), r(7, 6), r(9, 12)]
    Bs = [r(7, 9), r(4, 7), r(9, 130)]
    return As, Bs, [False, True, True], [False, True, False]


def test_trans_flags_bit_identical_to_jax():
    As, Bs, ta, tb = _trans_case()
    jA, jB, tA, tB = _both(As, Bs)
    want = jops.grouped_matmul(jA, jB, trans_a=ta, trans_b=tb)
    got = grouped_matmul(tA, tB, trans_a=ta, trans_b=tb)
    assert [tuple(o.shape) for o in got] == [(5, 9), (6, 4), (12, 130)]
    for g, (o, w) in enumerate(zip(got, want)):
        assert np.array_equal(o.numpy(), np.asarray(w)), g
    refs = ref.ref_grouped_gemm(tA, tB, trans_a=ta, trans_b=tb)
    jrefs = jref.ref_grouped_gemm(jA, jB, trans_a=ta, trans_b=tb)
    for o, r, jr in zip(got, refs, jrefs):
        assert torch.equal(o, r) and np.array_equal(r.numpy(), np.asarray(jr))
    _, _, descs, _ = gg.pack_groups(tA, tB, trans_a=ta, trans_b=tb)
    i_ta, i_tb = gg.DESC_FIELDS.index("trans_a"), gg.DESC_FIELDS.index("trans_b")
    assert descs[:, i_ta].tolist() == [0, 1, 1]
    assert descs[:, i_tb].tolist() == [0, 1, 0]


def test_wrapper_validates_the_launch_on_the_cpu():
    """What the kernel would be told is checked before the CPU takes the
    plain version: the table's shape, the 8-multiples of the 16-byte row
    loads and the buffers' bounds.  The JAX package's ``grid_dims`` and
    ``tiles`` are not taken: they sized the TPU grid."""
    A, B = torch.zeros(16, 16), torch.zeros(16, 16)
    ok = torch.tensor([[8, 8, 8, 0, 0, 0, 0, 0]], dtype=torch.int32)
    kw = dict(out_cols=8, out_rows=8)
    assert tuple(gg.grouped_gemm(A, B, ok, **kw).shape) == (8, 8)
    with pytest.raises(ValueError, match=r"\(G, 8\)"):
        gg.grouped_gemm(A, B, ok[:, :6], **kw)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        gg.grouped_gemm(A.double(), B, ok, **kw)
    with pytest.raises(ValueError, match="multiples of 8"):
        gg.grouped_gemm(A, B, torch.tensor([[8, 8, 4, 0, 0, 0, 0, 0]]), **kw)
    with pytest.raises(TypeError, match="grid_dims"):
        gg.grouped_gemm(A, B, ok, grid_dims=(1, 1, 1), **kw)
    with pytest.raises(ValueError, match="reaches past"):
        gg.grouped_gemm(A, B, torch.tensor([[8, 8, 8, 12, 0, 0, 0, 0]]), **kw)
    with pytest.raises(ValueError, match="row stride"):
        gg.grouped_gemm(torch.zeros(16, 12), B, ok, **kw)
    with pytest.raises(ValueError, match="unit stride"):
        gg.grouped_gemm(A.T[:, ::2], B, ok, **kw)
    assert gg.grouped_gemm.launches == 0


def test_cpu_tensors_take_the_plain_version():
    As, Bs = _rand_groups([(5, 17, 9), (12, 3, 33)], seed=9)
    tA, tB = interop.from_numpy((As, Bs), device="cpu")
    before = gg.grouped_gemm.launches
    got = ops.grouped_matmul(tA, tB, tiles=T8)
    assert all(o.device.type == "cpu" for o in got)
    assert gg.grouped_gemm.launches == before


def test_cpu_calls_count_no_route():
    As, Bs = _rand_groups([(5, 17, 9), (12, 3, 33)], seed=9)
    tA = [t.bfloat16() for t in interop.from_numpy(As, device="cpu")]
    tB = [t.bfloat16() for t in interop.from_numpy(Bs, device="cpu")]
    by_route = dict(gg.grouped_gemm.launches_by_route)
    ops.grouped_matmul(tA, tB)
    assert gg.grouped_gemm.launches_by_route == by_route
    assert set(by_route) == set(gg.ROUTES) == {"wgmma", "fma"}


def _bf16_groups(shapes, tiles=None, dtype=torch.bfloat16, b_dtype=None):
    As, Bs = _rand_groups(shapes, seed=12)
    tA = [t.to(dtype) for t in interop.from_numpy(As, device="cpu")]
    tB = [t.to(b_dtype or dtype) for t in interop.from_numpy(Bs, device="cpu")]
    A_flat, B_flat, descs, _ = gg.pack_groups(tA, tB, tiles)
    return A_flat, B_flat, descs


def _misaligned(X):
    """``X``'s values one element into a fresh buffer: a base pointer that
    is not 16-byte aligned."""
    flat = torch.zeros(X.numel() + 1, dtype=X.dtype)
    out = flat[1:].view(X.shape)
    out.copy_(X)
    return out


# (A_flat, B_flat, descs) builders and the route each must take
GROUPED_ROUTE_CASES = {
    "bf16_default_tiles": (lambda: _bf16_groups([(5, 130, 9), (20, 4, 140)]), "wgmma"),
    "bf16_k0_and_empty_groups": (
        lambda: _bf16_groups([(4, 5, 0), (0, 6, 6), (4, 0, 6), (4, 5, 6)]), "wgmma"),
    "bf16_f32_output_is_the_caller's": (
        lambda: _bf16_groups([(33, 7, 65), (2, 31, 4)]), "wgmma"),
    "float32": (lambda: _bf16_groups([(5, 130, 9)], dtype=torch.float32), "fma"),
    "mixed_types": (lambda: _bf16_groups([(5, 130, 9)], b_dtype=torch.float32), "fma"),
    "ragged_depth_t8": (lambda: _bf16_groups([(5, 17, 9), (12, 3, 33)], T8), "fma"),
    "depth_96": (lambda: _bf16_groups([(5, 17, 96)], {"k": 32}), "fma"),
    "ragged_depth_without_tiles_vetoes_nothing": (
        lambda: _bf16_groups([(0, 17, 9), (12, 0, 33), (5, 8, 64)], T8), "wgmma"),
    "misaligned_base": (
        lambda: (lambda A, B, d: (_misaligned(A), B, d))(*_bf16_groups([(5, 130, 9)])), "fma"),
}


@pytest.mark.parametrize("case", list(GROUPED_ROUTE_CASES))
def test_grouped_route_follows_dtype_layout_and_depths(case):
    """bf16 buffers a TMA map can describe, whose groups with output tiles
    all have depths that are multiples of 64, take ``wgmma``; float32,
    mixed types, a ragged depth or a misaligned base take ``fma``.  A group
    with no output tiles vetoes nothing; ``k_p == 0`` qualifies."""
    build, route = GROUPED_ROUTE_CASES[case]
    A_flat, B_flat, descs = build()
    assert gg.grouped_route(A_flat, B_flat, descs) == route
    assert gg.grouped_route(A_flat, B_flat, descs.tolist()) == route


def test_route_tiles_mirror_the_cuda_source():
    """The wrapper's tile list and depth rule use the kernels' own tiles:
    ``KERNEL_TILES``, ``WGMMA_DEPTH`` and ``FMA_DEPTH`` equal the
    ``#define``s of ``csrc/grouped_gemm.cu``; the wgmma ring fits a
    block's 232,448 bytes of shared memory, and the fma route's two f32
    stages (rows padded by 4 floats) fit the 48 KB of static shared
    memory, with 8 x 8 outputs for each of its 2 x GG_TU threads."""
    import re

    from repro_torch.kernels import _build

    text = (_build.CSRC / "grouped_gemm.cu").read_text()
    defs = {k: int(v) for k, v in re.findall(r"#define (G[GW]_\w+) (\d+)\b", text)}
    assert gg.KERNEL_TILES == {"wgmma": (defs["GW_TM"], defs["GW_TN"]),
                               "fma": (defs["GG_TU"], defs["GG_TV"])}
    assert gg.WGMMA_DEPTH == defs["GW_BK"]
    stage = (defs["GW_TM"] + defs["GW_TN"]) * defs["GW_BK"] * 2
    assert 1024 + defs["GW_STAGES"] * stage + 16 * defs["GW_STAGES"] <= 232_448
    assert gg.FMA_DEPTH == defs["GG_BK"]
    assert "#define GG_THREADS (2 * GG_TU)" in text
    assert "#define GG_LDA (GG_TU + 4)" in text and "#define GG_LDB (GG_TV + 4)" in text
    tu, tv = gg.KERNEL_TILES["fma"]
    assert tv == 128 and tu % 16 == 0    # columns 4 tx and 64 + 4 tx; rows 4 ty, tu / 2 + 4 ty
    assert 2 * gg.FMA_DEPTH * (tu + 4 + tv + 4) * 4 <= 48 * 1024


def _pack_per_group(As, Bs, descs, shapes):
    """The packing this module replaced: zero-filled buffers of the given
    shapes and one slice copy per group."""
    A_flat, B_flat = torch.zeros(shapes[0], dtype=As[0].dtype), torch.zeros(shapes[1], dtype=Bs[0].dtype)
    for (_, _, _, ao, bo, _, _, _), A, B in zip(descs.tolist(), As, Bs):
        if A.numel():
            A_flat[ao:ao + A.shape[0], :A.shape[1]].copy_(A)
        if B.numel():
            B_flat[bo:bo + B.shape[0], :B.shape[1]].copy_(B)
    return A_flat, B_flat


def _pack_case(case):
    """(As, Bs, tiles, trans_a, trans_b) as numpy arrays."""
    rng = np.random.default_rng(31)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    if case == "ragged_widths":
        return [r(5, 9), r(12, 33), r(1, 1), r(40, 8)], [r(9, 17), r(33, 3), r(1, 1), r(8, 20)], T8, False, False
    if case == "empty_groups":
        return ([r(4, 0), r(0, 6), r(4, 6), r(4, 6), r(0, 0)],
                [r(0, 5), r(6, 5), r(6, 0), r(6, 5), r(0, 3)], T8, False, False)
    if case == "trans_a":
        return [r(7, 5), r(9, 12), r(0, 3)], [r(7, 9), r(9, 130), r(0, 4)], None, True, False
    if case == "trans_b":
        return [r(5, 7), r(12, 9)], [r(9, 7), r(130, 9)], T8, False, True
    if case == "trans_both":
        return [r(7, 5), r(33, 12)], [r(9, 7), r(4, 33)], {"u": 8, "v": 32, "k": 32}, True, True
    if case == "per_group_flags":
        As, Bs, ta, tb = _trans_case()
        return As, Bs, None, ta, tb
    if case == "equal_widths":
        return [r(m, 24) for m in (3, 8, 0, 17)], [r(24, 16) for _ in range(4)], T8, False, False
    raise KeyError(case)


PACK_CASES = ["ragged_widths", "empty_groups", "trans_a", "trans_b", "trans_both",
              "per_group_flags", "equal_widths"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_groups_equals_per_group_packing_and_jax(case):
    """Packing by one row scatter per stored width gives, value for value,
    the buffers of the per-group copies it replaced and of the JAX
    package's ``pack_groups``: ragged widths, every trans flag, empty
    groups."""
    As, Bs, tiles, ta, tb = _pack_case(case)
    jA, jB, tA, tB = _both(As, Bs)
    A_flat, B_flat, descs, _ = gg.pack_groups(tA, tB, tiles, trans_a=ta, trans_b=tb)
    A_old, B_old = _pack_per_group(tA, tB, descs, (A_flat.shape, B_flat.shape))
    assert torch.equal(A_flat, A_old) and torch.equal(B_flat, B_old)
    jAf, jBf, jd, _ = jgg.pack_groups(jA, jB, tiles, trans_a=ta, trans_b=tb)
    assert np.array_equal(descs.numpy(), np.asarray(jd))
    assert np.array_equal(A_flat.numpy(), np.asarray(jAf))
    assert np.array_equal(B_flat.numpy(), np.asarray(jBf))


def test_row_blocks_of_one_tensor_pack_like_separate_groups():
    """Groups that are consecutive row blocks of one tensor (routed rows
    sorted by expert) are scattered from that tensor as one view; the
    buffer equals the one packed from separate copies of the groups."""
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.standard_normal((60, 24)).astype(np.float32))
    counts = [13, 0, 1, 30, 16]
    offs = np.concatenate([[0], np.cumsum(counts)])
    views = [X[offs[g]:offs[g + 1]] for g in range(len(counts))]
    Bs = [torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
          for _ in counts]
    A_view, B_view, descs, _ = gg.pack_groups(views, Bs, T8)
    A_copy, B_copy, descs_copy, _ = gg.pack_groups([v.clone() for v in views], Bs, T8)
    assert torch.equal(A_view, A_copy) and torch.equal(B_view, B_copy)
    assert torch.equal(descs, descs_copy)


@pytest.mark.parametrize("trans_b", [False, True])
def test_already_packed_weights_are_a_view(trans_b):
    """``list(W)`` of a contiguous expert weight tensor already is the
    packed B buffer under the default tiles: the buffer is a view of W's
    storage, with W's values, and no copy is made."""
    rng = np.random.default_rng(17)
    E, k, n = 3, 256, 384
    W = torch.from_numpy(rng.standard_normal((E, n, k) if trans_b else (E, k, n))
                         .astype(np.float32)).bfloat16()
    As = [torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
          for m in (5, 0, 17)]
    A_flat, B_flat, descs, _ = gg.pack_groups(As, list(W), trans_b=trans_b)
    assert B_flat.data_ptr() == W.data_ptr()
    assert torch.equal(B_flat, W.reshape(-1, W.shape[-1]))
    A_old, B_old = _pack_per_group(As, list(W), descs, (A_flat.shape, B_flat.shape))
    assert torch.equal(A_flat, A_old) and torch.equal(B_flat, B_old)
    # a view of a tensor that is not at the packed width is copied
    wide = torch.zeros(E * k, n + 8, dtype=torch.bfloat16)[:, :n]
    _, B_copy, _, _ = gg.pack_groups(As, list(wide.view(E, k, n)) if not trans_b else
                                     [w.T for w in wide.view(E, k, n)], trans_b=trans_b)
    assert B_copy.data_ptr() != wide.data_ptr()


def _packing_ops(n_groups: int) -> dict:
    """Copy, fill and scatter events that packing ``n_groups`` equal-width
    groups (separate tensors) dispatches, by name."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(n_groups)
    As = [torch.from_numpy(rng.standard_normal((int(m), 24)).astype(np.float32))
          for m in rng.integers(1, 20, n_groups)]
    Bs = [torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
          for _ in range(n_groups)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gg.pack_groups(As, Bs, T8)
    names = ("aten::copy_", "aten::fill_", "aten::zero_", "aten::index_copy_",
             "aten::index_fill_", "aten::cat")
    counts = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    return counts


def test_packing_launches_do_not_grow_with_the_groups():
    """60 equal-width groups dispatch as many copies, fills and scatters
    as 6 do: one ``torch.cat`` and one row scatter per operand, and one
    fill of the padding rows."""
    few, many = _packing_ops(6), _packing_ops(60)
    assert many == few
    assert sum(many.values()) <= 6
    assert many["aten::copy_"] == 0


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    As, Bs = _rand_groups(SHAPE_LISTS[0] + [(130, 260, 70)], seed=4)
    # T8 packing leaves ragged depths: both types on the fma route; the
    # default tiles give bf16 depths of 128: the wgmma route
    for dt, tol, tiles, route in ((torch.float32, 2e-5, T8, "fma"),
                                  (torch.bfloat16, 2e-2, T8, "fma"),
                                  (torch.bfloat16, 2e-2, None, "wgmma")):
        tA = [t.to(dt) for t in interop.from_numpy(As)]
        tB = [t.to(dt) for t in interop.from_numpy(Bs)]
        A_flat, B_flat, descs, problems = gg.pack_groups(tA, tB, tiles)
        _, out_rows, out_cols = gg.packed_geometry(problems, tiles)
        kw = dict(out_cols=out_cols, out_rows=out_rows)
        assert gg.grouped_route(A_flat, B_flat, descs) == route
        before = gg.grouped_gemm.launches_by_route[route]
        got = gg.grouped_gemm(A_flat, B_flat, descs, **kw)
        assert gg.grouped_gemm.launches_by_route[route] == before + 1
        want = gg.grouped_gemm_packed_ref(A_flat, B_flat, descs, **kw)
        torch.cuda.synchronize()
        for m, n, *_, c_off, _, _ in descs.tolist():
            torch.testing.assert_close(got[c_off:c_off + m, :n].float(),
                                       want[c_off:c_off + m, :n].float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("a_dtype,b_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16_x_f32"])
def test_fma_route_matches_plain_version_at_ragged_groups_on_the_card(a_dtype, b_dtype):
    """The fma route at ragged group sizes: groups off the 64 x 128 kernel
    tile and the 16-deep stage, an empty group and a k = 0 group, every
    trans combination, f32 and bf16 output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    shapes = [(130, 260, 70), (1, 300, 33), (77, 5, 513), (0, 9, 16), (40, 24, 0), (65, 129, 17)]
    ta, tb = [True, False, True, False, True, False], [False, True, True, False, False, True]
    rng = np.random.default_rng(21)
    As = [torch.from_numpy(rng.standard_normal((k, m) if t else (m, k)).astype(np.float32))
          .cuda().to(a_dtype) for (m, n, k), t in zip(shapes, ta)]
    Bs = [torch.from_numpy(rng.standard_normal((n, k) if t else (k, n)).astype(np.float32))
          .cuda().to(b_dtype) for (m, n, k), t in zip(shapes, tb)]
    for out_dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        A_flat, B_flat, descs, problems = gg.pack_groups(As, Bs, T8, trans_a=ta, trans_b=tb)
        _, out_rows, out_cols = gg.packed_geometry(problems, T8)
        kw = dict(out_cols=out_cols, out_rows=out_rows, out_dtype=out_dtype)
        assert gg.grouped_route(A_flat, B_flat, descs) == "fma"
        before = gg.grouped_gemm.launches_by_route["fma"]
        got = gg.grouped_gemm(A_flat, B_flat, descs, **kw)
        assert gg.grouped_gemm.launches_by_route["fma"] == before + 1
        want = gg.grouped_gemm_packed_ref(A_flat, B_flat, descs, **kw)
        torch.cuda.synchronize()
        for m, n, *_, c_off, _, _ in descs.tolist():
            torch.testing.assert_close(got[c_off:c_off + m, :n].float(),
                                       want[c_off:c_off + m, :n].float(), rtol=tol, atol=tol)
