"""Gradient compression for the cross-replica all-reduce.

* bf16 compression (2×): round to bf16 before the reduce, accumulate in f32;
* int8 block-quantized compression (4×) with per-block scales and
  **error feedback** (the residual carried to the next step), which keeps
  convergence intact.

The port of ``repro.distributed.compress``: the same arithmetic in the
same order, on trees of torch tensors.  The trainer applies it to the
gradient before the optimizer; on one device nothing is reduced, so it
changes the update exactly as a compressed reduce would.

A DTensor leaf (a trainer under sharding rules) is quantised over the
blocks of the global leaf flattened whole, as the JAX package's are under
GSPMD: it is gathered (``full_tensor()``), quantised as a plain tensor,
and each rank keeps its own block of the result and of the residual, each
placed as the leaf (a pending sum taken as summed).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import own_block, reduce_partial, spec_of
from repro_torch.models.tree import tree_map

__all__ = ["compress_bf16", "Int8Compressor"]


def compress_bf16(grads):
    """Lossy 2× compression: round to bf16 (and back to f32 for the update)."""
    return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)


class Int8Compressor:
    """Block-quantized int8 gradients with error feedback.

    ``compress(grads, residual)`` → (quantized-dequantized grads, new
    residual).  The quantization error is added back next step, so the
    *accumulated* gradient signal is unbiased.
    """

    def __init__(self, block: int = 256):
        self.block = block

    def init_residual(self, params):
        """float32 zeros shaped as each leaf; a DTensor leaf's placed as it
        is, each rank's block its own."""
        from torch.distributed.tensor import DTensor

        def zeros(p):
            if isinstance(p, DTensor):
                return torch.zeros_like(p, dtype=torch.float32,
                                        memory_format=torch.contiguous_format)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return tree_map(zeros, params)

    def _quant_dequant(self, g):
        flat = g.reshape(-1)
        pad = (-flat.numel()) % self.block
        flat = torch.nn.functional.pad(flat, (0, pad))
        blocks = flat.reshape(-1, self.block)
        scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.reshape(-1)[: g.numel()].reshape(g.shape)

    def compress(self, grads, residual):
        from torch.distributed.tensor import DTensor

        def one(g, r):
            if isinstance(g, DTensor):
                g = reduce_partial(g)
                full = g.full_tensor().float() + r.full_tensor()
                deq = self._quant_dequant(full)
                return _placed_like(deq, g), _placed_like(full - deq, r)
            g = g.float() + r
            deq = self._quant_dequant(g)
            return deq, g - deq

        pairs = tree_map(one, grads, residual)
        deq = tree_map(lambda _, pr: pr[0], grads, pairs)
        res = tree_map(lambda _, pr: pr[1], grads, pairs)
        return deq, res


def _placed_like(full, like):
    """``full``, the global value on every rank, as a DTensor placed as
    ``like``, this rank's block in a storage of its own (the global value is
    freed)."""
    from repro_torch.distributed.contract import as_dtensor  # deferred: it imports sharding

    return own_block(as_dtensor(full, spec_of(like), like.device_mesh))
