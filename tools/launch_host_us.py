"""Host microseconds per ``native_gemm`` launch, on the checkout given.

    python3 tools/launch_host_us.py [--tree <checkout>] [--tag <label>] [--calls 2000]

Imports ``repro_torch`` from ``<checkout>/src`` (default: the checkout that
holds this file), whose kernels load from ``<checkout>/build/kernels``
(built there on first use), so an older checkout unpacked beside this one
(``git archive``) is timed by the same script: run the older one, this
one, this one, the older one, in one card call.  Two bf16 products at
internlm2-20b's widths, ``bse,ef->bsf`` with W its KV projection (6144 x
1024): one row (a decode step's) and 2048 rows (a prefill's).  Each is
called 50 times, then ``--calls`` times back to back with one synchronize
at the end, three times.  Prints one JSON line per product: the tree, the
route ``native_route`` gives, the host µs a call (the loop before the
synchronize, over the calls), the wall µs a call (to the synchronize's
end) and the card's name and power limit as ``nvidia-smi`` prints them.
A loop whose wall time is its host time is host-bound: its µs a call is
what the Python launch path costs.  Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

#: internlm2-20b's d_model and KV heads x head dim
E, F = 6144, 8 * 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose src/repro_torch is timed")
    ap.add_argument("--tag", default="", help="label written into every line")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("launch_host_us: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels.sb_gemm import native_gemm, native_route

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(E, F, generator=gen, device=dev).bfloat16()
    kw = dict(a_modes="bse", b_modes="ef", c_modes="bsf")
    for rows in (1, 2048):
        x = torch.randn(1, rows, E, generator=gen, device=dev).bfloat16()
        for _ in range(50):
            native_gemm(x, w, **kw)
        host, wall = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                native_gemm(x, w, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append((t1 - t0) / args.calls * 1e6)
            wall.append((t2 - t0) / args.calls * 1e6)
        print(json.dumps(dict(
            tag=args.tag, tree=str(Path(repro_torch.__file__).resolve().parents[2]),
            spec="bse,ef->bsf", rows=rows, E=E, F=F, route=native_route(x, w, **kw),
            calls=args.calls, host_us=host, wall_us=wall, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
