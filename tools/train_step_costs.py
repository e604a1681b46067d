"""What one kernel-backend train step of an architecture costs, traced on
fake tensors: no card, no memory, no kernel build.

    PYTHONPATH=src python3 tools/train_step_costs.py --arch hubert-xlarge \\
        --batch 4 --seq-len 781 [--periods N]

Builds the port's ``make_train_step`` (AdamW, remat on, ``contract_backend=
"kernel"`` with ``contract_strategy="native"``) at the architecture's
published widths, ``--periods`` periods (default: its published depth),
and runs it once under ``FakeTensorMode`` inside ``utils.CostCounter`` on a
batch as ``training.data.make_batch_specs`` shapes it (features and labels
for a frontend model).  Prints one JSON line: the counter's flops, bytes
(every op's inputs and outputs: an unfused upper bound), fused bytes (each
storage a product or the step touches, once), the traced peak of
temporaries, the parameters' bytes (the AdamW moments take twice as
many) and ``native_gemm``'s calls by route.  These are counts from
shapes; no time.
"""

import argparse
import json
import time


def step_costs(arch: str, batch: int, seq_len: int, periods: int | None = None) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.transformer import init_params
    from repro_torch.models.tree import tree_leaves
    from repro_torch.training.data import make_batch_specs
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.trainer import TrainConfig, make_train_step
    from repro_torch.utils import CostCounter

    cfg = get_config(arch).with_(contract_backend="kernel", contract_strategy="native")
    if periods is not None:
        cfg = cfg.with_(n_periods=periods)
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(), remat=True))
    specs = make_batch_specs(cfg, ShapeSpec("step", seq_len, batch, "train"))
    t0 = time.perf_counter()
    with FakeTensorMode():
        params = init_params(None, cfg, device="cpu")
        state = adamw_init(params)
        param_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
        data = {k: torch.empty(v.shape, dtype=v.dtype, device="cpu") for k, v in specs.items()}
        with CostCounter() as cc:
            step(params, state, data, None)
    costs = cc.costs()
    return dict(arch=arch, n_periods=cfg.n_periods, batch=batch, seq_len=seq_len,
                **{k: costs[k] for k in ("flops", "bytes", "fused_bytes", "peak_bytes")},
                param_bytes=param_bytes,
                routes=costs["routes"].get("repro_torch.native_gemm", {}),
                trace_s=round(time.perf_counter() - t0, 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq-len", type=int, required=True)
    ap.add_argument("--periods", type=int, default=None)
    args = ap.parse_args()
    print(json.dumps(step_costs(args.arch, args.batch, args.seq_len, args.periods)))


if __name__ == "__main__":
    main()
