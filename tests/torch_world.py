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
