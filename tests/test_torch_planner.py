"""The port's planner, notation and addressing copies against the JAX
package's: Algorithm 2 must choose the same plan, field by field, for every
Table II case and every layout-fuzz spec, and the kernel's mode roles must
come out the same."""

import pytest

from layoutfuzz import gen_layout_case
from repro.core import notation as jnotation
from repro.core.planner import make_plan as jmake_plan
from repro.core.table2 import CASES as JCASES
from repro.kernels.addressing import native_mode_tiles as jnative_mode_tiles
from repro_torch import layoutfuzz as tlayoutfuzz
from repro_torch.core import notation as tnotation
from repro_torch.core.planner import make_plan as tmake_plan
from repro_torch.core.table2 import CASES as TCASES
from repro_torch.kernels.addressing import native_mode_tiles as tnative_mode_tiles

TABLE2_DIMS = {"m": 6, "n": 10, "p": 3, "k": 5}
N_FUZZ = 100


def _plan_fields(plan) -> tuple:
    return (plan.kind, plan.spec.spec_str(), plan.fspec.spec_str(),
            plan.flatten_groups, dict(plan.dims), dict(plan.fdims),
            plan.gemm_modes, plan.sb_batch, plan.nested, plan.notes,
            plan.copies)


def _assert_same_plans(spec: str, dims: dict) -> None:
    for allow_flatten in (True, False):
        j = jmake_plan(jnotation.parse_spec(spec), dims, allow_flatten=allow_flatten)
        t = tmake_plan(tnotation.parse_spec(spec), dims, allow_flatten=allow_flatten)
        assert _plan_fields(t) == _plan_fields(j), (spec, allow_flatten)
        assert t.describe() == j.describe()


def test_table2_cases_are_the_same():
    assert sorted(TCASES) == sorted(JCASES)
    for label, c in JCASES.items():
        t = TCASES[label]
        assert (t.row_major(), t.exceptional) == (c.row_major(), c.exceptional)


@pytest.mark.parametrize("label", sorted(JCASES))
def test_table2_plans_match_jax(label):
    _assert_same_plans(JCASES[label].row_major(), TABLE2_DIMS)


def test_layoutfuzz_stream_is_the_same():
    for i in range(N_FUZZ):
        cs_j, dims_j, A_j, B_j, tr_j = gen_layout_case(i)
        cs_t, dims_t, A_t, B_t, tr_t = tlayoutfuzz.gen_layout_case(i)
        assert (cs_t.spec_str(), dims_t, tr_t) == (cs_j.spec_str(), dims_j, tr_j)
        assert A_t.strides == A_j.strides and (A_t == A_j).all()
        assert B_t.strides == B_j.strides and (B_t == B_j).all()


@pytest.mark.parametrize("block", range(4))
def test_layoutfuzz_plans_match_jax(block):
    for i in range(block * N_FUZZ // 4, (block + 1) * N_FUZZ // 4):
        cs, dims, *_ = gen_layout_case(i)
        _assert_same_plans(cs.spec_str(), dims)


def test_native_mode_tiles_match_jax():
    specs = [(JCASES[l].row_major(), TABLE2_DIMS) for l in sorted(JCASES)]
    specs += [(cs.spec_str(), dims) for cs, dims, *_ in map(gen_layout_case, range(N_FUZZ))]
    for spec, dims in specs:
        cs = jnotation.parse_spec(spec)
        for tiles in (None, {"u": 16, "v": 256, "k": 64, "b": 4}):
            assert tnative_mode_tiles(cs.a_modes, cs.b_modes, cs.c_modes, dims, tiles) \
                == jnative_mode_tiles(cs.a_modes, cs.b_modes, cs.c_modes, dims, tiles), spec


@pytest.mark.parametrize("bad", ["aab,bc->ac", "ab,bc->ad", "ab,bc->aa",
                                 "ab...,bc->ac", "ab,bc,cd->ad"])
def test_parse_spec_rejects_like_jax(bad):
    with pytest.raises((ValueError, NotImplementedError)) as j:
        jnotation.parse_spec(bad)
    with pytest.raises(j.type):
        tnotation.parse_spec(bad)
