"""Time the float32 products that the fbatched route took over from
``generic``, on the checkout that holds this file.

    python3 tools/f32_times.py --tag <label>

Imports ``repro_torch`` and ``chip_smoke.py`` from this checkout alone; a
copy of the file in an older checkout's ``tools/`` times that checkout
(how a parent commit and a change are compared on one card).  Prints one JSON
line per product: HOOI's 512³ Gram ``mnp,mqp->nq``, the compiled
program's ``bik,kn->bin`` at 16×2048×1024×2048, and the 36 Table II
cases at n = 256 and n = 64, each with the route ``native_route`` gives,
the kernel's error against ``native_gemm_ref``, its ms and one
``torch.einsum``'s (TF32 off), both with their calls queued
(``chip_smoke.queued_ms``), and the bound.  The last line is the card's
name and power limit.  Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="label written into every line")
    args = ap.parse_args()
    tree = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    if not torch.cuda.is_available():
        print("f32_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.table2 import CASES
    from repro_torch.kernels.sb_gemm import native_gemm, native_gemm_ref, native_route

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def one(label, spec, A, B, reps):
        a, b, c = cs.modes_of(spec)
        kw = dict(a_modes=a, b_modes=b, c_modes=c)
        err = cs.rel_err(native_gemm(A, B, **kw), native_gemm_ref(A, B, **kw))
        b_ms, by = cs.bound(*cs.launch_cost(A, B, kw), torch.float32)
        print(json.dumps(dict(
            tag=args.tag, label=label, spec=spec, n=A.shape[-1],
            route=native_route(A, B, **kw), err=err, bound_ms=b_ms, bound_by=by,
            ms=cs.queued_ms(lambda: native_gemm(A, B, **kw), reps),
            library_ms=cs.queued_ms(lambda: torch.einsum(spec, A, B), reps))), flush=True)

    G = rn(512, 512, 512)
    one("gram", "mnp,mqp->nq", G, G, 3)
    del G
    one("program", "bik,kn->bin", rn(16, 2048, 1024), rn(1024, 2048), 3)
    for n in (256, 64):
        for label in sorted(CASES):
            spec = CASES[label].row_major()
            a, b, _ = cs.modes_of(spec)
            one(label, spec, rn(*[n] * len(a)), rn(*[n] * len(b)), 10)
    print(cs.device_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
