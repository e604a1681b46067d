"""Deterministic, checkpointable data pipeline.

Two sources:

* :class:`SyntheticLM` — seeded synthetic token streams (zipf-ish unigram +
  a copy structure so models can actually learn), used by the examples and
  tests; exactly reproducible from ``(seed, step)`` so a restore at step N
  continues the identical stream (fault-tolerance requirement).
* :class:`TokenFile` — memory-mapped binary token files (numpy ``.npy`` or
  raw uint16/uint32), sharded by host for multi-process launches.

Both expose ``state()`` / ``restore(state)`` so the trainer checkpoints the
pipeline alongside params.

The port of ``repro.training.data``: a copy (numpy gives the same batches
bit for bit), apart from :func:`make_batch_specs`, whose shapes come as
meta tensors where the JAX package gives ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "TokenFile", "make_batch_specs"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0
    #: fraction of each sequence that is a (learnable) copy of its prefix
    copy_frac: float = 0.5
    with_features: tuple | None = None  # (n_positions, feature_dim) stubs
    labels: bool = False

    def __post_init__(self):
        # zipf-ish unigram distribution, fixed by seed
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1)
        p = 1.0 / ranks**1.1
        self._p = p / p.sum()
        self._perm = rng.permutation(self.vocab_size)

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng((self.seed, self.step))
        B, S = self.global_batch, self.seq_len
        toks = rng.choice(self.vocab_size, size=(B, S), p=self._p)
        toks = self._perm[toks]
        # copy structure: second half repeats the first half shifted
        half = int(S * self.copy_frac) // 2
        if half > 4:
            toks[:, -half:] = toks[:, :half]
        batch = {"tokens": toks.astype(np.int32)}
        if self.with_features is not None:
            n, d = self.with_features
            n = n or S
            batch["features"] = rng.standard_normal((B, n, d)).astype(np.float32)
        if self.labels:
            batch["labels"] = toks.astype(np.int32)
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.seed, "restoring stream with wrong seed"
        self.step = int(state["step"])


@dataclasses.dataclass
class TokenFile:
    """Mmap-backed token stream with host sharding + restore."""

    path: str
    seq_len: int
    global_batch: int
    host_id: int = 0
    n_hosts: int = 1
    step: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        if self.path.endswith(".npy"):
            self._data = np.load(self.path, mmap_mode="r")
        else:
            self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._per_host = self.global_batch // self.n_hosts
        self._n_seqs = len(self._data) // self.seq_len

    def __iter__(self):
        return self

    def __next__(self):
        B, S = self._per_host, self.seq_len
        base = (self.step * self.global_batch + self.host_id * B) % max(
            self._n_seqs - B, 1
        )
        rows = [
            np.asarray(self._data[(base + i) * S : (base + i + 1) * S])
            for i in range(B)
        ]
        self.step += 1
        return {"tokens": np.stack(rows).astype(np.int32)}

    def state(self) -> dict:
        return {"step": self.step, "path": self.path}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])


def make_batch_specs(cfg, shape, dtype=np.int32):
    """Meta tensors (shape and dtype, no memory) for a config × shape cell."""
    import torch

    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.frontend is not None:
        n = S if cfg.frontend.kind == "audio" else cfg.frontend.n_positions
        specs["features"] = torch.empty(
            (B, n, cfg.frontend.feature_dim), dtype=torch.float32, device="meta"
        )
        specs["labels"] = torch.empty((B, S), dtype=torch.int32, device="meta")
    return specs
