"""Time the products that the retired ``generic`` route of ``native_gemm``
took (bf16 layouts no tensor map reads, mixed bf16 x float32 operands),
on the checkout that holds this file.

    python3 tools/former_generic_times.py --tag <label>

Imports ``repro_torch`` and ``chip_smoke.py`` from this checkout alone; a
copy of the file in an older checkout's ``tools/`` times that checkout
(how a parent commit and a change are compared on one card).  Prints one
JSON line per product: the 36 Table II cases in bf16 at ``chip_smoke``'s
``RAGGED_DIMS`` and at n = 255 (every stride odd), the 36 with A bf16 and
B float32 at n = 256, and two layouts ``chip_smoke.py`` forces (a weight
whose rows are 1030 bytes apart, experts whose rows are 500 bytes apart),
each with the route ``native_route`` gives, the kernel's error against
``native_gemm_ref``, its ms and one ``torch.einsum``'s on the same
operands (mixed: of A cast to float32 and B, the cast included), both
with their calls queued (``chip_smoke.queued_ms``), and the bound (the
bf16 peaks, or the FMA peak for the mixed set).  The last line is the
card's name and power limit.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="label written into every line")
    ap.add_argument("--reps", type=int, default=10, help="queued calls per time")
    args = ap.parse_args()
    tree = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    if not torch.cuda.is_available():
        print("former_generic_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(27)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    def one(group, label, spec, A, B):
        a, b, c = cs.modes_of(spec)
        kw = dict(a_modes=a, b_modes=b, c_modes=c)
        mixed = A.dtype != B.dtype
        err = cs.rel_err(native_gemm(A, B, **kw), native_gemm_ref(A, B, **kw))
        b_ms, by = cs.bound(*cs.launch_cost(A, B, kw), f32 if mixed else bf)
        lib = ((lambda: torch.einsum(spec, A.float(), B)) if mixed
               else (lambda: torch.einsum(spec, A, B)))
        print(json.dumps(dict(
            tag=args.tag, set=group, label=label, spec=spec,
            route=native_route(A, B, **kw), err=err, bound_ms=b_ms, bound_by=by,
            ms=cs.queued_ms(lambda: native_gemm(A, B, **kw), args.reps),
            library_ms=cs.queued_ms(lib, args.reps))), flush=True)

    sets = (("bf16 ragged", cs.RAGGED_DIMS, bf, bf),
            ("bf16 n=255", dict.fromkeys("mnpk", 255), bf, bf),
            ("mixed n=256", dict.fromkeys("mnpk", 256), bf, f32))
    for group, dims, a_dt, b_dt in sets:
        for label in sorted(CASES):
            spec = CASES[label].row_major()
            a, b, _ = cs.modes_of(spec)
            one(group, label, spec, rn([dims[m] for m in a], a_dt), rn([dims[m] for m in b], b_dt))
    one("layouts", "weight", "be,ef->bf", rn((4, 6144), bf), rn((6144, 515), bf)[:, :512])
    one("layouts", "experts", "xce,xef->xcf", rn((3, 341, 250), bf), rn((3, 250, 200), bf))
    print(cs.device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
