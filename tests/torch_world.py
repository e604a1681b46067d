"""A gloo world of CPU ranks for the port's sharded tests.

:class:`World` spawns one process per rank (``spawn`` context, so each
rank starts clean), joins them over a ``FileStore`` (no TCP rendezvous
port) into a gloo process group, and builds one named ``DeviceMesh``.
``world.run(fn, *args)`` runs ``fn(mesh, *args)`` on every rank and
returns the ranks' results in rank order; a rank's exception comes back
with its traceback and raises :class:`RankError`.  A case that does not
finish within the world's timeout raises too, and the world is torn down
(the next ``run`` starts a new one), so a hung collective fails its test
instead of stalling the suite.

This module imports neither JAX nor the JAX package: the ranks run only
the port.  ``fn`` must be a module-level function of a module the ranks
can import (this one).
"""

from __future__ import annotations

import datetime
import logging
import math
import multiprocessing
import os
import shutil
import tempfile
import time
import traceback

#: seconds a gloo collective may wait before it raises on its rank
COLLECTIVE_TIMEOUT_S = 60


class RankError(AssertionError):
    """A case raised on at least one rank; the message holds each failing
    rank's exception type, message and traceback."""


def _rank_main(rank, n, shape, names, store_path, conn):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # full_tensor() of a dim sharded over two mesh dims gathers twice, and
    # DTensor logs a warning per call saying so
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, n)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    conn.send(("ready", None))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args = msg
            try:
                conn.send(("ok", fn(mesh, *args)))
            except BaseException as e:  # noqa: BLE001 — every failure goes back
                conn.send(("error", (type(e).__name__, str(e), traceback.format_exc())))
    finally:
        dist.destroy_process_group()


class World:
    """``shape`` ranks in a gloo world with a ``DeviceMesh`` named ``names``."""

    def __init__(self, shape: tuple, names: tuple, timeout: float = 180.0):
        self.shape, self.names, self.timeout = tuple(shape), tuple(names), timeout
        self.n = math.prod(self.shape)
        self.procs: list = []
        self.conns: list = []
        self._dir = None

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="gloo-world-")
        store = os.path.join(self._dir, "store")
        for r in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(r, self.n, self.shape, self.names, store, child))
            p.start()
            child.close()
            self.procs.append(p)
            self.conns.append(parent)
        self._collect("starting the world")

    def _collect(self, what: str) -> list:
        deadline = time.monotonic() + self.timeout
        out, errors = [], []
        for r, c in enumerate(self.conns):
            if not c.poll(max(0.0, deadline - time.monotonic())):
                self.close()
                raise TimeoutError(f"rank {r} gave no answer within {self.timeout} s "
                                   f"({what}); the world was torn down")
            try:
                status, value = c.recv()
            except EOFError:
                self.close()
                raise RankError(f"rank {r} died ({what})") from None
            if status == "error":
                errors.append(f"rank {r}: {value[0]}: {value[1]}\n{value[2]}")
            out.append(value)
        if errors:
            raise RankError("\n".join(errors))
        return out

    def run(self, fn, *args) -> list:
        """``fn(mesh, *args)`` on every rank; the results in rank order."""
        if not self.procs:
            self._start()
        for c in self.conns:
            c.send((fn, args))
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for c in self.conns:
            c.close()
        self.procs, self.conns = [], []
        if self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


# ------------------------------------------------------------ rank-side cases
def _operand(x, mesh):
    """A numpy array is the global value on every rank (a plain tensor);
    ``("dtensor", array, spec)`` is that value as a DTensor with ``spec``'s
    placements."""
    import torch

    from repro_torch.distributed.contract import as_dtensor

    if isinstance(x, tuple) and x[0] == "dtensor":
        return as_dtensor(torch.from_numpy(x[1]), x[2], mesh)
    return torch.from_numpy(x)


def _plan_record(plan) -> dict | None:
    if plan is None:
        return None
    return dict(describe=plan.describe(), a_spec=tuple(plan.a_spec),
                b_spec=tuple(plan.b_spec), out_spec=tuple(plan.out_spec),
                slice_a=plan.slice_a, slice_b=plan.slice_b, scatters=plan.scatters,
                psum_axes=plan.psum_axes, gathers=plan.gathers, slice_out=plan.slice_out)


def call(mesh, entry: str, spec: str, operands, kwargs: dict) -> dict:
    """Run one of the port's sharded entry points on this rank's blocks:
    ``entry`` is ``"contract"``, ``"sharded_contract"``, ``"xeinsum"`` or
    ``"compile_program"``.  Returns the global result (``full_tensor``),
    its ``PartitionSpec``, this rank's block shape and the plan, if one
    came back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.contract import contract
    from repro_torch.core.einsum import xeinsum
    from repro_torch.core.program import compile_program
    from repro_torch.distributed.contract import sharded_contract
    from repro_torch.distributed.sharding import spec_of

    tensors = [_operand(x, mesh) for x in operands]
    if entry == "compile_program":
        out = compile_program(spec, *tensors, mesh=mesh, **kwargs)(*tensors)
    else:
        fn = {"contract": contract, "sharded_contract": sharded_contract,
              "xeinsum": xeinsum}[entry]
        out = fn(spec, *tensors, mesh=mesh, **kwargs)
    plan = None
    if isinstance(out, tuple):
        out, plan = out
    assert isinstance(out, DTensor), type(out)
    return dict(full=out.full_tensor().numpy(), spec=tuple(spec_of(out)),
                local_shape=tuple(out.to_local().shape), plan=_plan_record(plan))


def block_order(mesh, n: int, entry) -> dict:
    """This rank's coordinate and its block of ``arange(n)`` sharded by
    ``entry`` on dim 0: through the port's view, through DTensor's own
    ``distribute_tensor`` on the port's placements, and through a
    sharded contraction's result."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.contract import sharded_contract
    from repro_torch.distributed.sharding import P, local_block, placements

    x = torch.arange(n, dtype=torch.float32)
    spec = P(entry)
    out = sharded_contract("m,n->mn", x, torch.ones(1), mesh=mesh, in_specs=(spec, None))
    return dict(coord=tuple(mesh.get_coordinate()),
                view=local_block(x, spec, mesh).tolist(),
                dtensor=distribute_tensor(x, mesh, placements(spec, mesh)).to_local().tolist(),
                contract=out.to_local()[:, 0].tolist(),
                full=out.full_tensor()[:, 0].tolist())


def replicated_views(mesh) -> list:
    """For a replicated operand (and one whose contracted mode another
    operand shards, so it is sliced per rank): whether each local block
    the contraction gets is a view of the global tensor (same storage, no
    copy)."""
    import torch

    from repro_torch.core import contract as core_contract
    from repro_torch.distributed.contract import sharded_contract
    from repro_torch.distributed.sharding import P

    A, B = torch.randn(8, 12), torch.randn(12, 16)
    seen = []
    real = core_contract.contract

    def spy(spec, a, b, **kw):
        seen.append([t.untyped_storage().data_ptr() == g.untyped_storage().data_ptr()
                     for t, g in ((a, A), (b, B))])
        return real(spec, a, b, **kw)

    core_contract.contract = spy
    try:
        sharded_contract("mk,kn->mn", A, B, mesh=mesh, in_specs=(P("x", "y"), None))
        sharded_contract("mk,kn->mn", A, B, mesh=mesh, in_specs=(None, None))
    finally:
        core_contract.contract = real
    return seen



def grad_case(mesh, spec, a, b, w, in_specs, out_spec, backend, dtensor) -> dict:
    """``sharded_contract`` under autograd on this rank: the gradients of
    ``sum(C * w)`` (``C`` gathered whole) with respect to the leaves ``a``
    and ``b``, passed as plain tensors or, with ``dtensor``, as DTensors
    of their ``in_specs`` (then also the mask of the elements this rank's
    block holds)."""
    import torch

    from repro_torch.distributed.contract import as_dtensor, sharded_contract
    from repro_torch.distributed.sharding import local_block

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (a, b)]
    ops = [as_dtensor(t, s, mesh) if dtensor else t for t, s in zip(leaves, in_specs)]
    kw = {"strategy": "native"} if backend == "kernel" else {}
    C = sharded_contract(spec, *ops, mesh=mesh, in_specs=in_specs, out_spec=out_spec,
                         backend=backend, **kw)
    (C.full_tensor() * torch.from_numpy(w)).sum().backward()
    masks = []
    for t, s in zip(leaves, in_specs):
        m = torch.zeros(t.shape, dtype=torch.int64)
        local_block(m, s, mesh).fill_(1)
        masks.append(m.numpy())
    return dict(grads=[None if t.grad is None else t.grad.numpy() for t in leaves],
                masks=masks)


def _smoke_config(arch: str, overrides: dict):
    from repro_torch.configs import get_config

    return get_config(arch, smoke=True).with_(**overrides)


def place(mesh, tree, axes_fn: str, rules_overrides: dict | None = None):
    """``tree`` on ``mesh`` by the default rules (with ``rules_overrides``)
    and the :mod:`repro_torch.launch.shardings` assignment ``axes_fn``."""
    from repro_torch.distributed.sharding import ShardingRules, device_put
    from repro_torch.launch import shardings

    rules = ShardingRules(mesh, rules_overrides)
    axes = getattr(shardings, axes_fn)(tree)
    return rules, device_put(tree, shardings.tree_shardings(rules, axes, tree))


def sharded_loss(mesh, arch: str, overrides: dict, np_params, np_batch) -> float:
    """``lm_loss`` of the numpy weights and batch, placed on ``mesh`` by
    the default rules and run under them."""
    import torch

    from repro_torch.distributed.sharding import use_rules
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.transformer import lm_loss

    cfg = _smoke_config(arch, overrides)
    rules, params = place(mesh, params_from_numpy(cfg, np_params, "cpu"),
                          "param_logical_axes")
    _, batch = place(mesh, {k: torch.from_numpy(v) for k, v in np_batch.items()},
                     "batch_logical_axes")
    with use_rules(rules):
        loss, _ = lm_loss(cfg, params, batch)
    return float(loss.full_tensor())


def sharded_grads(mesh, arch: str, overrides: dict, np_params, np_batch,
                  backward_thread: bool = False, rules_overrides: dict | None = None) -> dict:
    """``value_and_grad`` on the placed weights and batch under the default
    rules (with ``rules_overrides``): the loss and every gradient leaf
    gathered whole (numpy, in ``tree_leaves`` order).  With
    ``backward_thread`` the backward pass
    runs on a thread of its own, which has neither the rules nor DTensor's
    implicit replication (per-thread settings), as autograd's device
    thread on the card has not."""
    import threading

    import torch

    from repro_torch.distributed.sharding import use_rules
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.tree import tree_leaves
    from repro_torch.training.trainer import value_and_grad

    cfg = _smoke_config(arch, overrides)
    rules, params = place(mesh, params_from_numpy(cfg, np_params, "cpu"),
                          "param_logical_axes", rules_overrides)
    _, batch = place(mesh, {k: torch.from_numpy(v) for k, v in np_batch.items()},
                     "batch_logical_axes", rules_overrides)
    grad = torch.autograd.grad
    if backward_thread:
        def on_a_thread(*args, **kwargs):
            out = []
            t = threading.Thread(target=lambda: out.append(grad(*args, **kwargs)))
            t.start()
            t.join()
            if not out:
                raise RuntimeError("the backward thread raised (see its traceback)")
            return out[0]

        torch.autograd.grad = on_a_thread
    try:
        with use_rules(rules):
            loss, _, grads = value_and_grad(cfg, params, batch)
    finally:
        torch.autograd.grad = grad
    return dict(loss=float(loss.full_tensor()),
                grads=[g.full_tensor().numpy() for g in tree_leaves(grads)])


def vocab_loss(mesh, arch: str, overrides: dict, np_params, np_batch,
               rules_overrides: dict | None = None) -> dict:
    """:func:`sharded_grads` under the default rules with
    ``rules_overrides``, and what ``layers.token_nll`` got: the logits'
    ``PartitionSpec`` and the width of this rank's vocab block."""
    from repro_torch.distributed.sharding import spec_of
    from repro_torch.models import layers

    seen, real = [], layers.token_nll

    def spy(logits, targets):
        seen.append((tuple(spec_of(logits)), logits.to_local().shape[-1]))
        return real(logits, targets)

    layers.token_nll = spy
    try:
        out = sharded_grads(mesh, arch, overrides, np_params, np_batch,
                            rules_overrides=rules_overrides)
    finally:
        layers.token_nll = real
    (spec, width), = seen
    return dict(out, spec=spec, vocab_block=width)


def sharded_train(mesh, arch: str, overrides: dict, np_params, data_kw: dict,
                  train_kw: dict, steps: int, ckpt_dir=None, restore=False) -> dict:
    """``Trainer(rules=ShardingRules(mesh))`` from the numpy weights on a
    ``SyntheticLM(**data_kw)`` stream: ``steps`` steps (after a restore
    from ``ckpt_dir`` with ``restore``), then a forced checkpoint there if
    one is given.  Returns the losses, the step and each parameter leaf
    (gathered whole) with its placements."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.tree import tree_leaves
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = _smoke_config(arch, overrides)
    opt = AdamWConfig(**train_kw.pop("opt", {}))
    tcfg = TrainConfig(opt=opt, ckpt_dir=ckpt_dir, **train_kw)
    tr = Trainer(cfg, tcfg, params_from_numpy(cfg, np_params, "cpu"), SyntheticLM(**data_kw),
                 rules=ShardingRules(mesh))
    if restore:
        tr.restore()
    losses = [h["loss"] for h in tr.run(steps)]
    if ckpt_dir is not None:
        tr.save(force=True)
    residual = tree_leaves(tr.residual) if tr.residual is not None else []
    return dict(losses=losses, step=tr.step,
                params=[p.full_tensor().numpy() for p in tree_leaves(tr.params)],
                placements=[tuple(map(str, p.placements)) for p in tree_leaves(tr.params)],
                opt_placements=[tuple(map(str, p.placements))
                                for p in tree_leaves(tr.opt_state["mu"])],
                residual=[r.full_tensor().numpy() for r in residual],
                residual_placements=[tuple(map(str, r.placements)) for r in residual])


def sharded_int8(mesh, arch: str, overrides: dict, np_params, np_batch, np_residual) -> dict:
    """``value_and_grad`` on the placed weights and batch under the default
    rules, then ``Int8Compressor.compress`` of that DTensor gradient with
    the residual ``np_residual`` (one array per leaf) placed as the
    parameters: the gradient, the compressed gradient and the new residual,
    each leaf gathered whole, and whether every compressed and residual
    leaf is a DTensor placed as its parameter."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.compress import Int8Compressor
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.tree import tree_leaves, tree_unflatten
    from repro_torch.training.trainer import value_and_grad

    cfg = _smoke_config(arch, overrides)
    rules, params = place(mesh, params_from_numpy(cfg, np_params, "cpu"),
                          "param_logical_axes")
    _, batch = place(mesh, {k: torch.from_numpy(v) for k, v in np_batch.items()},
                     "batch_logical_axes")
    _, residual = place(mesh, tree_unflatten(params, [torch.from_numpy(r) for r in np_residual]),
                        "param_logical_axes")
    with use_rules(rules):
        _, _, grads = value_and_grad(cfg, params, batch)
    deq, res = Int8Compressor().compress(grads, residual)
    placed = all(isinstance(x, DTensor) and x.placements == p.placements
                 for p, d, r in zip(tree_leaves(params), tree_leaves(deq), tree_leaves(res))
                 for x in (d, r))
    return dict(grads=[g.full_tensor().numpy() for g in tree_leaves(grads)],
                deq=[d.full_tensor().numpy() for d in tree_leaves(deq)],
                res=[r.full_tensor().numpy() for r in tree_leaves(res)], placed=placed)


def sharded_serve(mesh, arch: str, overrides: dict, np_params, prompts, max_new: int,
                  engine_kw: dict, legacy: bool = True) -> list:
    """Greedy tokens of ``prompts`` served on ``mesh`` from the numpy
    weights: through ``ServeEngine`` (``legacy``) or ``ServingRuntime``."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.runtime.engine import ServingRuntime
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = _smoke_config(arch, overrides)
    params = params_from_numpy(cfg, np_params, "cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    if legacy:
        ServeEngine(cfg, params, mesh=mesh, **engine_kw).serve(reqs)
    else:
        ServingRuntime(cfg, params, mesh=mesh, **engine_kw).serve(reqs)
    return [list(r.output) for r in reqs]


def sharded_restore(mesh, arch: str, overrides: dict, ckpt_dir: str) -> dict:
    """``restore_checkpoint(shardings=)`` of a parameter checkpoint onto
    ``mesh``: the step, each leaf gathered whole, its placements and the
    placements ``tree_shardings`` gives it."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.shardings import param_logical_axes, tree_shardings
    from repro_torch.models.tree import tree_leaves
    from repro_torch.training.checkpoint import restore_checkpoint

    cfg = _smoke_config(arch, overrides)
    like = _zeros_like_params(cfg)
    sh = tree_shardings(ShardingRules(mesh), param_logical_axes(like), like)
    tree, _, step = restore_checkpoint(ckpt_dir, None, like, shardings=sh)
    return dict(step=step, leaves=[t.full_tensor().numpy() for t in tree_leaves(tree)],
                placements=[tuple(t.placements) for t in tree_leaves(tree)],
                want=[s.placements for s in tree_leaves(sh)])


def _zeros_like_params(cfg):
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.models.tree import tree_map

    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                    init_params(None, cfg, device="meta"))


def _moe_placed(mesh, np_params, np_x):
    """The moe weights placed by ``launch/shardings``' rules for a moe
    block and the tokens by the residual stream's (``batch``,
    ``seq_sharded``), under the default rules on ``mesh``."""
    import torch

    from repro_torch.distributed.contract import as_dtensor
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.shardings import param_logical_axes, tree_shardings

    rules = ShardingRules(mesh)
    tree = {"moe": {k: torch.from_numpy(v) for k, v in np_params.items()}}
    sh = tree_shardings(rules, param_logical_axes(tree), tree)["moe"]
    params = {k: as_dtensor(v, sh[k].spec, mesh) for k, v in tree["moe"].items()}
    x = torch.from_numpy(np_x)
    return params, as_dtensor(x, rules.physical(("batch", "seq_sharded", None)), mesh)


def a2a_layer(mesh, overrides: dict, np_params, np_x, np_c=None, dtensor=False) -> dict:
    """``moe_ffn_a2a`` of the numpy expert weights and tokens on ``mesh``:
    the output gathered whole and, with ``np_c``, the gradients of
    ``sum(y * c)``.  Plain operands give this rank's share of each
    gradient (their sum over ranks is the gradient); with ``dtensor`` the
    operands are DTensors placed as a model places them, and each
    gradient comes back gathered whole."""
    import torch

    from repro_torch.distributed.moe_a2a import moe_ffn_a2a

    cfg = _smoke_config("qwen2-moe-a2.7b", overrides)
    if dtensor:
        params, x = _moe_placed(mesh, np_params, np_x)
        leaves = [x] + [params[k] for k in sorted(params)]
        for t in leaves:
            t.requires_grad_(np_c is not None)
    else:
        params = {k: torch.from_numpy(v).requires_grad_(np_c is not None)
                  for k, v in np_params.items()}
        x = torch.from_numpy(np_x).requires_grad_(np_c is not None)
        leaves = [x] + [params[k] for k in sorted(params)]
    y = moe_ffn_a2a(cfg, params, x, mesh)
    out = dict(y=y.full_tensor().detach().numpy(), spec=tuple(map(str, y.placements)))
    if np_c is not None:
        names = ["x"] + sorted(params)
        grads = torch.autograd.grad((y.full_tensor() * torch.from_numpy(np_c)).sum(), leaves)
        out["grads"] = {n: (g.full_tensor() if dtensor else g).numpy()
                        for n, g in zip(names, grads)}
    return out


def a2a_owned(mesh, np_w):
    """The experts this rank takes of the stack ``np_w`` (placed as a
    model places ``moe/wi``: experts over ``model``, hidden width over
    ``data``) for the a2a products, in bfloat16, as float32 numpy."""
    import numpy as np
    import torch

    from repro_torch.distributed.contract import _process_group
    from repro_torch.distributed.moe_a2a import _owned
    from repro_torch.distributed.sharding import group_index

    params, _ = _moe_placed(mesh, {"wi": np_w}, np.zeros((*mesh.shape, 1), np.float32))
    axes = tuple(mesh.mesh_dim_names)
    D = mesh.size()
    Xloc = -(-np_w.shape[0] // D)
    own = _owned(params["wi"], mesh, axes, _process_group(mesh, axes),
                 group_index(axes, mesh), D, Xloc, torch.bfloat16)
    return own.float().numpy()


def pipeline_case(mesh, np_ws, np_x, np_c=None, backend="torch", dtensor=False) -> dict:
    """``pipeline_forward`` of ``tanh(x @ W[s])`` stages over the ``pod``
    axis: the output and, with ``np_c``, ``pipeline_loss``'s gradients of
    ``sum(y * c)`` with respect to the stacked weights and ``x`` (this
    rank's; with ``dtensor`` the weights are a DTensor sharded over
    ``pod`` and their gradient comes back whole), and the rank's stage."""
    import torch

    from repro_torch.core.contract import contract
    from repro_torch.distributed.contract import as_dtensor
    from repro_torch.distributed.pipeline import pipeline_forward, pipeline_loss
    from repro_torch.distributed.sharding import P

    kw = {"strategy": "native", "backend": "kernel"} if backend == "kernel" else {}

    def stage_fn(params, x, stage_idx):
        return torch.tanh(contract("bd,de->be", x, params["W"], **kw))

    ws = torch.from_numpy(np_ws).requires_grad_(np_c is not None)
    x = torch.from_numpy(np_x).requires_grad_(np_c is not None)
    W = as_dtensor(ws, P("pod"), mesh) if dtensor else ws
    stage = mesh.get_local_rank("pod")
    if np_c is None:
        return dict(y=pipeline_forward(mesh, stage_fn, {"W": W}, x).numpy(), stage=stage)
    c = torch.from_numpy(np_c)
    loss = pipeline_loss(mesh, stage_fn, {"W": W}, x, c, lambda y, t: (y * t).sum())
    gw, gx = torch.autograd.grad(loss, [W, x])
    return dict(loss=float(loss), stage=stage, gx=gx.numpy(),
                gw=(gw.full_tensor() if dtensor else gw).numpy())
