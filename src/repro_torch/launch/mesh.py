"""Mesh construction over a ``torch.distributed`` world.

A mesh is a ``DeviceMesh`` with named axes over the ranks of the current
world.  Nothing here runs at import: the world is started (or found) when
a mesh is asked for.
"""

from __future__ import annotations

import contextlib
import io
import os

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_host_mesh", "parse_mesh_shape", "cli_mesh"]


def parse_mesh_shape(arg: str) -> tuple[int, int]:
    """Parse a ``--mesh DATAxMODEL`` CLI argument, e.g. ``"2x4"`` → (2, 4)."""
    try:
        data, model = (int(p) for p in arg.lower().split("x"))
    except ValueError as e:
        raise ValueError(
            f"--mesh wants DATAxMODEL (e.g. '2x4'), got {arg!r}"
        ) from e
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be positive, got {arg!r}")
    return data, model


def _mesh(shape: tuple, names: tuple, device: str):
    from torch.distributed.device_mesh import init_device_mesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card; pass device='cpu' for a CPU mesh")
    n = 1
    for d in shape:
        n *= d
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh {'x'.join(map(str, shape))} needs a world of {n} ranks: start one "
                f"with torch.distributed.init_process_group first")
        # a world of one needs no rendezvous: an in-process store
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs a world of {n} ranks, "
                         f"the world has {dist.get_world_size()}")
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16×16 = 256-rank pod; multi_pod=True adds the 2-pod axis (512).
    The world must already have that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"the production mesh needs a world of {n} ranks, have {have}")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A ``("data", "model")`` mesh over the current world, whose size must
    be ``data * model``.  Without a world, a mesh of one starts one itself
    over an in-process store: NCCL on the card, gloo with ``device="cpu"``."""
    return _mesh((data, model), ("data", "model"), device)


@contextlib.contextmanager
def cli_mesh(arg: str | None, device: str):
    """The mesh of a launcher's ``--mesh DATAxMODEL`` flag (``None``
    without one), for the length of the ``with`` block.

    Under ``python -m torch.distributed.run`` (``WORLD_SIZE`` in the
    environment) every rank joins the launcher's world (gloo on the CPU,
    NCCL on the card); ``1x1`` needs no launcher (a world of one).  Only
    rank 0 prints.  A world started here is destroyed on exit.  Without a
    launcher a mesh of more than one rank exits with a message naming it.
    """
    if arg is None:
        yield None
        return
    data, model = parse_mesh_shape(arg)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group("nccl" if device == "cuda" else "gloo")
        elif data * model > 1:
            raise SystemExit(
                f"--mesh {arg} needs {data * model} ranks: launch it with "
                f"python -m torch.distributed.run --nproc-per-node {data * model} ...")
    try:
        mesh = make_host_mesh(data, model, device=device)
        if dist.get_rank():
            with contextlib.redirect_stdout(io.StringIO()):
                yield mesh
        else:
            yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
