"""Fault-tolerant checkpointing with atomic commits.

* **Atomicity** — write to ``step_N.tmp/``, fsync, then ``rename`` to
  ``step_N/`` and update ``MANIFEST``; a crash mid-write never corrupts the
  latest checkpoint (restore reads the manifest, never the directory list).
* **Placement** — arrays are saved whole, one ``leaf_%05d.npy`` per leaf;
  restore places each leaf on its target's device.
* **Pipeline state** — the data-stream cursor and optimizer step travel
  with the params, so restore resumes the exact token stream.
* **Retention** — ``keep`` newest checkpoints are retained; older are
  deleted only after the manifest points elsewhere.

The port of ``repro.training.checkpoint``, in its on-disk format: leaves
are numbered in ``jax.tree.flatten`` order (:func:`repro_torch.models.tree.
tree_leaves`: dict keys sorted), so a checkpoint the JAX package's
``Trainer`` writes restores into the port's, and the other way round.
The port stores a bfloat16 leaf as float32 (numpy has no bfloat16 of its
own); restore casts each leaf to its target's dtype.

Sharded trees (DTensor leaves, a trainer under sharding rules) are saved
**unsharded**: every rank gathers each leaf whole (``full_tensor()``, a
collective), rank 0 alone writes and commits, and the others wait at a
barrier, so the ranks never race on one ``.tmp`` directory.  Restore
with ``shardings=`` (a tree of :class:`~repro_torch.distributed.sharding.
NamedSharding` matching ``like``) places each leaf on its sharding, so a
checkpoint written on any mesh, or on none, restores onto any other.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import device_put
from repro_torch.interop import from_numpy
from repro_torch.models.tree import tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "Checkpointer"]

_MANIFEST = "MANIFEST.json"


def _to_numpy(leaf) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = leaf.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _treedef(tree) -> str:
    """A printable structure of ``tree`` (informational, as JAX's is)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    return "*"


def save_checkpoint(ckpt_dir: str, step: int, tree, *, extra: dict | None = None,
                    keep: int = 3) -> str:
    """Atomically save a tree (params/opt state/metrics) at ``step``.

    A tree with DTensor leaves is gathered whole on every rank (all ranks
    must call this), written by rank 0 alone, and the call returns on
    every rank after the commit."""
    from torch.distributed.tensor import DTensor

    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    leaves = tree_leaves(tree)
    if any(isinstance(leaf, DTensor) for leaf in leaves):
        arrays = [_to_numpy(leaf) for leaf in leaves]  # collectives: every rank
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, step, tree, arrays, extra, keep)
        dist.barrier()
    else:
        _write(ckpt_dir, final, step, tree, leaves, extra, keep)
    return final


def _write(ckpt_dir: str, final: str, step: int, tree, leaves, extra, keep: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(final):  # idempotent: this step is already committed
        return
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    meta = {"n_leaves": len(leaves), "treedef": _treedef(tree),
            "extra": extra or {}, "step": step}
    for i, leaf in enumerate(leaves):
        arr = leaf if isinstance(leaf, np.ndarray) else _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())

    os.rename(tmp, final)  # atomic commit
    _update_manifest(ckpt_dir, step)
    _gc(ckpt_dir, keep)


def _update_manifest(ckpt_dir: str, step: int) -> None:
    path = os.path.join(ckpt_dir, _MANIFEST)
    tmp = path + ".tmp"
    steps = []
    if os.path.exists(path):
        with open(path) as f:
            steps = json.load(f)["steps"]
    steps = sorted(set(steps) | {step})
    with open(tmp, "w") as f:
        json.dump({"steps": steps, "latest": steps[-1]}, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _gc(ckpt_dir: str, keep: int) -> None:
    path = os.path.join(ckpt_dir, _MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    steps = manifest["steps"]
    for s in steps[:-keep] if keep else []:
        d = os.path.join(ckpt_dir, f"step_{s:010d}")
        if os.path.exists(d):
            shutil.rmtree(d)
    manifest["steps"] = steps[-keep:] if keep else steps
    with open(path, "w") as f:
        json.dump(manifest, f)


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["latest"]


def restore_checkpoint(ckpt_dir: str, step: int | None, like, *, shardings=None):
    """Restore into the structure of ``like``: each leaf takes its
    counterpart's dtype and device, and with ``shardings`` its sharding.
    Returns ``(tree, extra, step)``."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves_like = tree_leaves(like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, target {len(leaves_like)}")
    out = []
    for i, ref in enumerate(leaves_like):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, target "
                             f"{tuple(ref.shape)}")
        out.append(from_numpy(arr, ref.device).to(ref.dtype))
    tree = tree_unflatten(like, out)
    if shardings is not None:
        tree = device_put(tree, shardings)
    return tree, meta["extra"], step


class Checkpointer:
    """Convenience wrapper carrying dir/keep and last-saved bookkeeping."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every: int = 100):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every

    def maybe_save(self, step: int, tree, extra=None, force=False):
        if force or (step % self.every == 0 and step > 0):
            return save_checkpoint(self.dir, step, tree, extra=extra, keep=self.keep)
        return None

    def restore(self, like, shardings=None, step=None):
        return restore_checkpoint(self.dir, step, like, shardings=shardings)

    @property
    def latest(self):
        return latest_step(self.dir)
