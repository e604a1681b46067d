"""Hand arrays from the JAX package (as numpy) to the port, with no JAX.

:func:`from_numpy` turns numpy arrays — operands, HOSVD factors, the
fields of a result dataclass — into the port's tensors on one device, so
both packages can run on identical state.  Each array crosses with its
strides: a transposed, sliced or stride-0 (broadcast) numpy view becomes
a tensor view of the same layout over a copy of the memory it spans.
Negative strides have no torch counterpart; such arrays are copied into
packed layout at the boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "from_numpy"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising ``RuntimeError`` for a CUDA
    device when there is no card (rather than falling back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _array_to_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    if x.size == 0:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    # a length-1 axis may carry any stride (numpy keeps a negative one even
    # in "contiguous" arrays); it never moves the pointer, so call it 0
    if any(d > 1 and (s < 0 or s % x.itemsize) for d, s in zip(x.shape, x.strides)):
        x = np.ascontiguousarray(x)
    strides = tuple(s // x.itemsize if d > 1 else 0 for d, s in zip(x.shape, x.strides))
    # the flat run of memory from the first element to the last one
    span = 1 + sum((d - 1) * s for d, s in zip(x.shape, strides))
    flat = np.lib.stride_tricks.as_strided(x, shape=(span,), strides=(x.itemsize,))
    buf = torch.from_numpy(np.array(flat)).to(device)
    return buf.as_strided(x.shape, strides)


def from_numpy(tree, device="cuda"):
    """Convert every numpy array (or numpy scalar) in ``tree`` — nested
    tuples, lists, dicts and dataclass instances — to a tensor on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``).  Other leaves pass through unchanged."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, (np.ndarray, np.generic)):
            return _array_to_tensor(np.asarray(x), dev)
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(
                x, **{f.name: conv(getattr(x, f.name))
                      for f in dataclasses.fields(x) if f.init})
        return x

    return conv(tree)
