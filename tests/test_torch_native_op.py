"""``repro_torch::native_gemm``, the registered operator behind
``sb_gemm.native_gemm``, on the CPU.

* ``torch.library.opcheck`` (schema, autograd registration, fake kernel,
  AOT dispatch) on float32 and bfloat16 operands: a permuted view, a view
  at a storage offset, an exceptional Table II layout (3.4) and products
  whose contracted modes are two;
* under ``FakeTensorMode`` the op gives the real CPU output's shape, type
  and strides, and on fake tensors ``native_plan`` picks the real
  tensors' route (a fake start is its storage offset over an aligned
  base);
* its flop formula is ``FlopCounterMode``'s count of ``torch.einsum`` on
  the same product, and ``CostCounter`` counts its calls by name and by
  route, on real and fake tensors alike;
* it is forward only (no gradient, on the CPU as on the card), it counts
  no launch on the CPU, it refuses DTensor operands, and the wrapper's
  checks run before it.

The operands are made from a seed with numpy; the kernel itself runs only
on the card (``tests/test_torch_kernels.py``'s ``gpu`` cases and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.table2 import CASES, EXCEPTIONAL_CASES
from repro_torch.kernels.sb_gemm import (
    NATIVE_GEMM_OP, native_gemm, native_gemm_ref, native_plan, native_route,
)
from repro_torch.utils import CostCounter

RNG = np.random.default_rng(0)


def _t(*shape, dtype=torch.float32):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(dtype)


def _cases(dtype):
    """``(label, A, B, a_modes, b_modes, c_modes)``: the layouts the op
    must take as they are."""
    exc = CASES["3.4"]
    assert "3.4" in EXCEPTIONAL_CASES
    a, b = exc.row_major().split("->")[0].split(",")
    c = exc.row_major().split("->")[1]
    dims = {"m": 6, "n": 5, "p": 4, "k": 7}
    big = _t(40, dtype=dtype)
    return [
        ("permuted", _t(7, 6, dtype=dtype).t(), _t(7, 5, dtype=dtype), "mk", "kn", "mn"),
        ("offset", big[3:33].view(6, 5), _t(5, 4, dtype=dtype), "mk", "kn", "mn"),
        ("table2-3.4", _t(*[dims[m] for m in a], dtype=dtype),
         _t(*[dims[m] for m in b], dtype=dtype), a, b, c),
        ("two-contracted", _t(3, 4, 5, dtype=dtype), _t(4, 5, 6, dtype=dtype),
         "bkl", "klc", "bc"),
        ("batched", _t(3, 2, 4, dtype=dtype).permute(1, 0, 2), _t(2, 4, 5, dtype=dtype),
         "gmk", "gkn", "gmn"),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", range(5), ids=["permuted", "offset", "table2-3.4",
                                                "two-contracted", "batched"])
def test_opcheck(dtype, case):
    label, A, B, a, b, c = _cases(dtype)[case]
    out = torch.promote_types(A.dtype, B.dtype)
    opcheck(NATIVE_GEMM_OP, (A, B, a, b, c, out))
    got = NATIVE_GEMM_OP(A, B, a, b, c, out)
    want = native_gemm_ref(A, B, a_modes=a, b_modes=b, c_modes=c, out_dtype=out)
    assert got.is_contiguous() and torch.equal(got, want.contiguous()), label


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fake_output_and_route_match_the_real_call(dtype):
    mode = FakeTensorMode()
    for label, A, B, a, b, c in _cases(dtype):
        kw = dict(a_modes=a, b_modes=b, c_modes=c)
        real = native_gemm(A, B, **kw, out_dtype=torch.float32)
        fA, fB = mode.from_tensor(A), mode.from_tensor(B)
        with mode:
            fake = native_gemm(fA, fB, **kw, out_dtype=torch.float32)
            fake_route = native_route(fA, fB, **kw)
        assert (fake.shape, fake.dtype, fake.stride(), fake.device) == (
            real.shape, real.dtype, real.stride(), real.device), label
        assert fake_route == native_route(A, B, **kw), label


def test_fake_start_is_its_storage_offset():
    """A bf16 operand one element past an aligned start cannot be read by
    a tensor map on the card: on fake tensors the plan sees that too."""
    mode = FakeTensorMode()
    W = _t(64, 64, dtype=torch.bfloat16)
    big = _t(8 + 8 * 64, dtype=torch.bfloat16)
    kw = dict(a_modes="mk", b_modes="kn", c_modes="mn")
    for start, want in ((8, "wgmma"), (1, "gathered")):
        X = big[start:start + 8 * 64].view(8, 64)
        with mode:
            route = native_route(mode.from_tensor(X), mode.from_tensor(W), **kw)
        assert route == want, start
        # the CPU's allocations are 64-byte aligned, as the card's are
        assert native_route(X, W, **kw) == want


@pytest.mark.parametrize("spec,shapes", [("mk,kn->mn", ((6, 7), (7, 5))),
                                         ("gmk,gkn->gmn", ((3, 4, 5), (3, 5, 6))),
                                         ("bkl,klc->bc", ((3, 4, 5), (4, 5, 6))),
                                         ("km,pkn->pnm", ((4, 6), (3, 4, 5)))])
def test_flop_formula_counts_the_library_einsum(spec, shapes):
    A, B = _t(*shapes[0]), _t(*shapes[1])
    a, rest = spec.split(",")
    b, c = rest.split("->")
    with FlopCounterMode(display=False) as lib:
        torch.einsum(spec, A, B)
    with FlopCounterMode(display=False) as op:
        native_gemm(A, B, a_modes=a, b_modes=b, c_modes=c)
    dims = {**dict(zip(a, A.shape)), **dict(zip(b, B.shape))}
    assert (op.get_total_flops() == lib.get_total_flops()
            == 2 * int(np.prod(list(dims.values()))))


def test_cost_counter_counts_calls_by_name_and_route():
    A, B = _t(64, 32), _t(32, 8)
    kw = dict(a_modes="mk", b_modes="kn", c_modes="mn")
    route = native_route(A, B, **kw)

    def run(x, y):
        with CostCounter() as cc:
            native_gemm(x, y, **kw)
            native_gemm(x, y, **kw)
            torch.mm(x, y)
        return cc.costs()

    real = run(A, B)
    mode = FakeTensorMode()
    fA, fB = mode.from_tensor(A), mode.from_tensor(B)
    with mode:
        fake = run(fA, fB)
    for got in (real, fake):
        assert got["ops"] == {"repro_torch.native_gemm": 2, "aten.mm": 1}
        assert got["routes"] == {"repro_torch.native_gemm": {route: 2}}
        assert got["flops"] == 3 * 2 * 64 * 32 * 8
    assert real == fake


def test_forward_only_counts_nothing_on_the_cpu_and_refuses_dtensors():
    A, B = _t(4, 3).requires_grad_(), _t(3, 5)
    before = (native_gemm.launches, dict(native_gemm.launches_by_route))
    out = native_gemm(A, B, a_modes="mk", b_modes="kn", c_modes="mn")
    assert not out.requires_grad and out.grad_fn is None
    assert (native_gemm.launches, native_gemm.launches_by_route) == before
    with pytest.raises(ValueError, match="CUDA \\(or CPU\\)"):
        native_gemm(A.detach().to("meta"), B.to("meta"), a_modes="mk", b_modes="kn",
                    c_modes="mn")

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        dA = DTensor.from_local(A.detach(), mesh, [Replicate(), Replicate()])
        dB = DTensor.from_local(B, mesh, [Replicate(), Replicate()])
        with pytest.raises(Exception, match="native_gemm"):
            NATIVE_GEMM_OP(dA, dB, "mk", "kn", "mn", torch.float32)
    finally:
        dist.destroy_process_group()


def test_native_plan_runs_on_fake_tensors_without_a_data_pointer(monkeypatch):
    """The plan reads a fake operand's start from its storage offset, never
    from ``data_ptr()`` (which a fake tensor has not)."""
    from torch._subclasses.fake_tensor import FakeTensor

    def no_pointer(self):
        raise RuntimeError("a fake tensor has no data pointer")

    monkeypatch.setattr(FakeTensor, "data_ptr", no_pointer)
    mode = FakeTensorMode()
    for dtype in (torch.float32, torch.bfloat16):
        for label, A, B, a, b, c in _cases(dtype):
            with mode:
                route, _ = native_plan(mode.from_tensor(A), mode.from_tensor(B), a_modes=a,
                                       b_modes=b, c_modes=c)
            assert route == native_route(A, B, a_modes=a, b_modes=b, c_modes=c), label
