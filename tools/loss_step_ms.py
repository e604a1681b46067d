"""Device ms of the language-model loss and of a training step, on the
checkout given.

    python3 tools/loss_step_ms.py [--tree <checkout>] [--tag <label>] [--reps 10]

Imports ``repro_torch`` from ``<checkout>/src`` (default: the checkout that
holds this file), so an older checkout unpacked beside this one (``git
archive``) is timed by the same script: run the older one, this one, this
one, the older one, in one card call.  The shapes are ``chip_smoke.py``
phase 13's: minicpm-2b at its published widths, 4 layers, 4 x 512 tokens,
on the ``torch`` backend (no kernel to build; the loss is the same on
both backends).

* ``loss``: ``lm_loss`` and its backward on fixed logits (4, 512, 122880)
  f32, the model's forward stubbed out, so only the loss's own ops run:
  ms a call by CUDA events (median and all), and the bytes the call
  allocates above what was allocated before it (``max_memory_allocated``).
* ``step``: ``training.trainer.value_and_grad`` on the model: ms a step
  by CUDA events (median and all) and the step's peak allocation.

Prints one JSON line per measurement with the tree, the tag and the
card's name and power limit as ``nvidia-smi`` prints them.  Needs a CUDA
card.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ARCH, PERIODS, BATCH, SEQ = "minicpm-2b", 4, 4, 512


def _events_ms(fn, reps: int) -> list:
    import torch

    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _peak_above(fn) -> int:
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose src/repro_torch is timed")
    ap.add_argument("--tag", default="", help="label written into every line")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("loss_step_ms: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.transformer import init_params, lm_loss
    from repro_torch.training.trainer import value_and_grad

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    tree = str(Path(repro_torch.__file__).resolve().parents[2])
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH).with_(n_periods=PERIODS)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen, device=dev)
    batch = {"tokens": tokens}

    def line(what, ms, peak):
        print(json.dumps(dict(tag=args.tag, tree=tree, what=what, ms_median=statistics.median(ms),
                              ms=ms, peak_bytes=peak, card=card)), flush=True)

    logits = torch.randn(BATCH, SEQ, cfg.vocab_size, generator=gen, device=dev) * 4
    logits.requires_grad_(True)
    zero = torch.zeros((), device=dev)
    real_forward = transformer.forward
    transformer.forward = lambda cfg, params, batch, remat=True: (
        logits, {"load_balance_loss": zero})

    def loss_call():
        total, _ = lm_loss(cfg, {}, batch)
        (g,) = torch.autograd.grad(total, logits)
        return g

    try:
        _events_ms(loss_call, 3)
        peak = _peak_above(loss_call)
        line("loss", _events_ms(loss_call, args.reps), peak)
    finally:
        transformer.forward = real_forward
    del logits

    params = init_params(gen, cfg)

    def step():
        return value_and_grad(cfg, params, batch)

    _events_ms(step, 2)
    peak = _peak_above(step)
    line("step", _events_ms(step, args.reps), peak)
    return 0


if __name__ == "__main__":
    sys.exit(main())
