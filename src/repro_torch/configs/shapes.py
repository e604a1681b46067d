"""The four assigned input-shape suites (LM family).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``.  Applicability rules (see
DESIGN.md §Arch-applicability): encoder-only archs have no decode shapes;
``long_500k`` runs only for sub-quadratic (SSM/hybrid) archs.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ShapeSpec", "SHAPES", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs that may run long_500k (sub-quadratic decode path)
SUBQUADRATIC = {"mamba2-1.3b", "jamba-v0.1-52b"}


def applicable_shapes(cfg) -> dict[str, ShapeSpec | None]:
    """Map shape name → spec (or None with a skip reason encoded)."""
    out: dict[str, ShapeSpec | None] = {}
    for name, spec in SHAPES.items():
        if spec.kind == "decode" and cfg.encoder_only:
            out[name] = None  # encoder-only: no autoregressive step
        elif name == "long_500k" and cfg.arch_id not in SUBQUADRATIC:
            out[name] = None  # pure full-attention arch: skip per assignment
        else:
            out[name] = spec
    return out
