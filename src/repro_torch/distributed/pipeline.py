"""GPipe-style pipeline parallelism over a mesh axis.

Stages are laid over an axis (default ``pod``) of a ``DeviceMesh``: the
rank at coordinate ``s`` on that axis holds stage ``s``'s slice of the
stage parameters, and microbatches flow through a ring shift
(``batch_isend_irecv`` on the axis's process group).  The schedule is
the classic fill–steady–drain loop of ``n_micro + n_stages - 1`` ticks:
at tick ``t`` stage ``s`` works on microbatch ``t - s``; only stage 0
reads the input; the last stage records finished microbatches, and a sum
over the axis hands them to every stage.

The port of ``repro.distributed.pipeline``.  A stage with no microbatch
at a tick passes its buffer on without calling ``stage_fn`` (the JAX
package computes and discards; the result is the same).  Under autograd
the whole schedule is one autograd Function whose backward runs the
ticks in reverse on every rank in lockstep: the ring shift's dual is the
reverse shift, and the final sum's dual hands the last stage the
gradient of the output it holds (every rank computes the same loss from
the replicated output).  A shift or sum over an axis of one rank is not
issued.

Stage parameters are plain tensors holding the global value (leading
axis ``n_stages``) or DTensors on the mesh; each rank uses only its
stage's slice, and its gradient comes back there alone (for a plain
leaf, the gradient is the sum over the stage axis).  ``x`` is a plain
tensor, the same on every rank; so is the result.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import P
from repro_torch.models.tree import tree_leaves, tree_unflatten

__all__ = ["pipeline_forward", "pipeline_loss"]


def _stage_slice(p, stage: int, mesh, axis: str):
    """Stage ``stage``'s slice of a stacked parameter leaf: a view of a
    plain tensor, this rank's block of a DTensor placed on the axis."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.contract import as_dtensor

    if isinstance(p, DTensor):
        return as_dtensor(p, P(axis), mesh).to_local()[0]
    return p[stage]


class _Ring:
    """The ring over ``axis``: this rank's stage and its neighbours'
    global ranks."""

    def __init__(self, mesh, axis: str):
        names = tuple(mesh.mesh_dim_names)
        if axis not in names:
            raise ValueError(f"mesh {names} has no axis {axis!r}")
        self.n = mesh.shape[names.index(axis)]
        self.stage = mesh.get_local_rank(axis)
        self.pg = mesh.get_group(axis) if self.n > 1 else None
        if self.pg is not None:
            self.next = dist.get_global_rank(self.pg, (self.stage + 1) % self.n)
            self.prev = dist.get_global_rank(self.pg, (self.stage - 1) % self.n)

    def shift(self, t, *, back: bool = False):
        """``t`` sent one stage on (``back``: one stage back), and what the
        other neighbour sent here."""
        if self.pg is None:
            return t
        dst, src = (self.prev, self.next) if back else (self.next, self.prev)
        t = t.contiguous()
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst, group=self.pg),
                                       dist.P2POp(dist.irecv, out, src, group=self.pg)])
        for r in reqs:
            r.wait()
        return out

    def psum(self, t):
        if self.pg is not None:
            t = t.contiguous()
            dist.all_reduce(t, group=self.pg)
        return t


def _schedule(ring, stage_fn, treedef, params, x, n_micro: int, record: bool):
    """Run the ticks; returns the replicated outputs and, with ``record``,
    each active tick's ``(input, output)`` with their graphs."""
    s, n_stages = ring.stage, ring.n
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    ticks = {}
    for t in range(n_micro + n_stages - 1):
        mb = t - s  # microbatch this stage handles at tick t
        active = 0 <= mb < n_micro
        if active:
            inp = x[min(t, n_micro - 1)] if s == 0 else buf
            if record:
                inp = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(tree_unflatten(treedef, params), inp, s)
                ticks[t] = inp, y
                y = y.detach()
            else:
                y = stage_fn(tree_unflatten(treedef, params), inp, s)
            if y.shape != buf.shape or y.dtype != buf.dtype:
                raise ValueError(f"stage_fn gave {y.dtype}{tuple(y.shape)}; a stage must "
                                 f"keep its input's {buf.dtype}{tuple(buf.shape)}")
            if s == n_stages - 1:
                outs[mb] = y
        else:
            y = buf
        buf = ring.shift(y)  # the last stage's output falls off the ring
    # only the last stage wrote outputs; the sum hands them to every stage
    return ring.psum(outs), ticks


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, stage_fn, treedef, n_micro, x, *params):
        live = [p.detach().requires_grad_(p.requires_grad) for p in params]
        out, ticks = _schedule(ring, stage_fn, treedef, live, x, n_micro, record=True)
        ctx.ring, ctx.n_micro, ctx.ticks, ctx.live = ring, n_micro, ticks, live
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return out

    @staticmethod
    def backward(ctx, g_out):
        ring, n_micro, ticks = ctx.ring, ctx.n_micro, ctx.ticks
        s, n_stages = ring.stage, ring.n
        wanted = [p for p in ctx.live if p.requires_grad]
        g_params = [None] * len(wanted)
        g_x = g_out.new_zeros(ctx.x_shape, dtype=ctx.x_dtype) if ctx.needs_input_grad[4] else None
        g_buf = None  # gradient of this stage's buffer at tick t + 1
        for t in reversed(range(n_micro + n_stages - 1)):
            mb = t - s
            active = 0 <= mb < n_micro
            # the reverse shift: what the next stage's buffer took from y
            if ring.pg is None:
                g_y = g_buf
            else:
                send = g_buf if g_buf is not None else g_out.new_zeros(ctx.x_shape[1:],
                                                                       dtype=ctx.x_dtype)
                g_y = ring.shift(send, back=True)
            if active and s == n_stages - 1:
                g_y = g_out[mb] if g_y is None else g_y + g_out[mb]
            if not active:
                g_buf = g_y  # y was the buffer
                continue
            inp, y = ticks.pop(t)
            if g_y is None:
                g_buf = None
                continue
            got = torch.autograd.grad(y, [inp] + wanted, g_y, allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
            if s == 0:
                if g_x is not None and got[0] is not None:
                    g_x[t] = got[0]
                g_buf = None  # stage 0 reads the input, not its buffer
            else:
                g_buf = got[0]
        it = iter(g_params)
        grads = [next(it) if p.requires_grad else None for p in ctx.live]
        return (None, None, None, None, g_x, *grads)


def pipeline_forward(mesh, stage_fn, stage_params, x, *, axis: str = "pod"):
    """Run ``x`` through ``n_stages`` calls of ``stage_fn`` laid out over
    ``axis`` of ``mesh`` (a ``DeviceMesh``).

    ``stage_fn(params, x, stage_idx) -> x`` takes one stage's parameters
    (the tree ``stage_params`` with each leaf's leading ``n_stages`` axis
    indexed) and one microbatch, and returns a tensor of the microbatch's
    shape and type; ``x`` is ``(n_micro, micro_batch, ...)`` with
    ``n_micro >= n_stages``.  Returns the ``(n_micro, ...)`` outputs of
    the last stage on every rank."""
    ring = _Ring(mesh, axis)
    n_micro = x.shape[0]
    if n_micro < ring.n:
        raise ValueError(f"need >= n_stages microbatches to fill the pipe: {n_micro} "
                         f"microbatches for {ring.n} stages")
    leaves = tree_leaves(stage_params)
    local = [_stage_slice(p, ring.stage, mesh, axis) for p in leaves]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, *local]):
        return _Pipeline.apply(ring, stage_fn, stage_params, n_micro, x, *local)
    return _schedule(ring, stage_fn, stage_params, local, x, n_micro, record=False)[0]


def pipeline_loss(mesh, stage_fn, stage_params, x, targets, loss_fn, *, axis="pod"):
    """Convenience: pipeline forward + replicated loss."""
    y = pipeline_forward(mesh, stage_fn, stage_params, x, axis=axis)
    return loss_fn(y, targets)
