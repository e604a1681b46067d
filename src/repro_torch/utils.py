"""Cost counting for one traced step: the port's counter of what a step
does on one device.

The JAX package reads a step's costs from XLA (``compiled_costs`` over
``compiled.cost_analysis()``, ``memory_analysis()`` and a parse of the
optimized HLO for its collectives).  The port has no compiler to ask: it
runs the step itself, eagerly, usually on fake tensors in a fake process
group (:mod:`repro_torch.launch.dryrun`), under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every ATen op the step dispatches on one
rank and counts:

* ``flops`` — ``torch.utils.flop_counter``'s registered formulas
  (``flop_registry``: the matrix products, convolutions and attention
  kernels), on plain tensors only.  An op with a DTensor operand is handed
  back to DTensor (the mode returns ``NotImplemented``, as
  ``CommDebugMode`` does); DTensor lowers it to this rank's local ops,
  which the mode then counts.  So a sharded product counts its local
  block's flops once, never the global product as well.
* ``bytes`` — the bytes of every tensor input and output of every op that
  writes a tensor and is not a view, a collective or an ``empty``
  factory (a query such as ``prim.device`` moves nothing).  This is an
  *unfused upper bound*: each op reads and writes its operands in full,
  where XLA's fused "bytes accessed" would keep a fusion's intermediates
  on chip.
* ``fused_bytes`` — the traffic of the step fused down to its products:
  the bytes of every distinct storage that the step takes (:meth:`hold`),
  returns (:meth:`output`) or that a product (an op with a flop formula)
  reads or writes, each counted once.  Every other op is taken as fused
  into a product, so this is the least that a step whose products read
  and write memory must move: the memory term of a roofline bound.
* ``collective_bytes`` / ``collective_counts`` — per kind (the JAX
  package's names: all-gather, all-reduce, reduce-scatter, all-to-all,
  collective-permute), the result-shape bytes and the number of each
  collective of ``c10d`` (the tensors it writes) and of
  ``c10d_functional`` / ``_c10d_functional`` (the tensor it returns), as
  the JAX package sums the result shapes of the HLO's collectives.  A
  point-to-point shift counts on its receiving side only (``recv_``), as
  XLA's collective-permute counts its result once.
* ``ops`` — the calls of each op with a flop formula (the products), by
  name (``aten.mm``, ``repro_torch.native_gemm``): the launches a step
  makes; ``routes`` — for an op in :data:`ROUTERS`, its calls by the
  route its kernel takes.
* ``peak_bytes`` — the most bytes held by live storages at once:
  :meth:`CostCounter.hold` registers the step's arguments, and every
  storage an op creates counts from its creation until it is freed.
  ``argument_bytes`` are the arguments' part; ``peak_live`` names the
  largest storages live at the peak (the op that made each, its shape
  and type).  Memory an op's kernel takes internally (a library's
  workspace, ``native_gemm``'s split partial sums) is not seen.

The JAX package's ``normalize_cost_analysis`` / ``compiled_costs`` are not
carried over: they normalise XLA's ``cost_analysis()``, which has no
counterpart without XLA.
"""

from __future__ import annotations

import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["CostCounter", "COLLECTIVE_KINDS", "ROUTERS", "collective_kind", "tensor_bytes"]

#: op overload → a function of its arguments that names the route its
#: kernel takes; :class:`CostCounter` counts such an op's calls by route
#: (``repro_torch.kernels.sb_gemm`` registers ``repro_torch.native_gemm``)
ROUTERS: dict = {}

#: collective op name (any of the c10d namespaces) → the JAX package's kind
_KIND_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "recv_": "collective-permute",
}
_FUNCTIONAL = ("c10d_functional", "_c10d_functional", "_c10d_functional_autograd")
COLLECTIVE_KINDS = tuple(dict.fromkeys(_KIND_OF.values()))

_NO_DATA = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided"})


def collective_kind(func) -> str | None:
    """The collective kind of an ATen op overload, or ``None``."""
    if func.namespace != "c10d" and func.namespace not in _FUNCTIONAL:
        return None
    return _KIND_OF.get(func.overloadpacket.__name__)


def tensor_bytes(tree) -> int:
    """The bytes of the tensor leaves of ``tree`` (numel × itemsize)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes, collectives and the peak of live storage of the
    ops run under it, on this rank (see the module docstring).

    ::

        with CostCounter() as cc:
            cc.hold((params, opt_state, batch))
            out = step(params, opt_state, batch)
        cc.costs()
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.fused_bytes = 0
        self.output_bytes = 0
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.collective_counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.ops: dict[str, int] = {}
        self.routes: dict[str, dict[str, int]] = {}
        self._live: dict[int, int] = {}
        self._made: dict[int, tuple] = {}   # storage → (op, shape, dtype)
        self._at_peak: dict[int, tuple] = {}
        self._fused: set[int] = set()   # storages counted in fused_bytes
        self._muted = threading.local()  # per thread: inside DTensor's propagation
        self._unpatch = None

    def __enter__(self):
        # DTensor derives an op's global output shape by running the op on
        # fake global tensors (once per op signature: the result is
        # cached); that run is not this rank's work, so the ops that its
        # thread dispatches meanwhile are not counted
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        meta = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached", None)
        if meta is None:
            raise RuntimeError(
                "torch.distributed.tensor's ShardingPropagator has no "
                "_propagate_tensor_meta_non_cached: CostCounter cannot tell DTensor's shape "
                "propagation from this rank's ops, and would count the global op as well")
        state = self._muted

        def muted(prop, op_schema):
            state.depth = getattr(state, "depth", 0) + 1
            try:
                return meta(prop, op_schema)
            finally:
                state.depth -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        self._unpatch = lambda: setattr(
            ShardingPropagator, "_propagate_tensor_meta_non_cached", meta)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    # ------------------------------------------------------------ storage
    def _track(self, t: torch.Tensor, op: str) -> int:
        """Count ``t``'s storage, made by ``op``, as live until it is
        freed; the bytes added (0 for a storage already counted)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self._made[key] = (op, tuple(t.shape), str(t.dtype).removeprefix("torch."))
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self._at_peak = {k: (self._made[k], m) for k, m in self._live.items()}
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._made.pop(key, None)
        self._fused.discard(key)

    def _count_fused(self, tree) -> int:
        """Count each storage of ``tree``'s tensors (a DTensor's local
        block) in ``fused_bytes`` once; the bytes of its distinct
        storages."""
        from torch.distributed.tensor import DTensor

        seen = {}
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st._cdata] = st
        for key, st in seen.items():
            if key not in self._fused:
                self._fused.add(key)
                self.fused_bytes += st.nbytes()
                if key not in self._live:  # no finalizer of _track's
                    weakref.finalize(st, self._fused.discard, key)
        return sum(st.nbytes() for st in seen.values())

    def hold(self, tree) -> int:
        """Register the storages of ``tree``'s tensors (a DTensor's local
        block) as live arguments; returns the bytes added."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                added += self._track(t, "argument")
        self.argument_bytes += added
        self._count_fused(tree)
        return added

    def output(self, tree) -> int:
        """Register ``tree``'s tensors as what the step returns (each
        storage written once in ``fused_bytes``); returns the bytes of
        their distinct storages, added to ``output_bytes``."""
        n = self._count_fused(tree)
        self.output_bytes += n
        return n

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(self._muted, "depth", 0):
            return out
        kind = collective_kind(func)
        formula = None if kind else self._flop_formulas.get(func.overloadpacket)
        if kind is not None:
            written = out if func.namespace in _FUNCTIONAL else args[0]
            self.collective_bytes[kind] += tensor_bytes(written)
            self.collective_counts[kind] += 1
        else:
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
                name = f"{func.namespace}.{func.overloadpacket.__name__}"
                self.ops[name] = self.ops.get(name, 0) + 1
                router = ROUTERS.get(func)
                if router is not None:
                    by = self.routes.setdefault(name, {})
                    route = router(*args, **kwargs)
                    by[route] = by.get(route, 0) + 1
            written = tensor_bytes(out)
            if written and not func.is_view and func.overloadpacket.__name__ not in _NO_DATA:
                self.bytes += tensor_bytes((args, kwargs)) + written
        if not func.is_view:
            # a new storage is an allocation; one an input has (in place,
            # ``out=``) is not
            seen = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)}
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor)
                        and t.untyped_storage()._cdata not in seen):
                    self._track(t, str(func))
        if formula is not None:  # a product's operands cross memory
            self._count_fused((args, kwargs, out))
        return out

    # ------------------------------------------------------------- result
    def peak_live(self, top: int = 5) -> list[dict]:
        """The ``top`` largest groups of storages live at the peak, by the
        op that made them, their shape and type: ``op``, ``shape``,
        ``dtype``, ``count`` and ``bytes``, largest first."""
        groups: dict[tuple, list] = {}
        for made, n in self._at_peak.values():
            g = groups.setdefault(made, [0, 0])
            g[0] += 1
            g[1] += n
        ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
        return [{"op": op, "shape": list(shape), "dtype": dt, "count": c, "bytes": b}
                for (op, shape, dt), (c, b) in ranked]

    def costs(self) -> dict:
        """The counts so far: ``flops``, ``bytes`` (unfused upper bound),
        ``fused_bytes``, ``collective_bytes`` and ``collective_counts`` by
        kind, ``ops`` (the products' calls by name), ``routes`` (by op
        and route, for the ops of :data:`ROUTERS`), ``peak_bytes``
        (arguments included), ``argument_bytes``, ``output_bytes``,
        ``temp_bytes`` (the peak less the arguments) and ``peak_live``
        (:meth:`peak_live`)."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "fused_bytes": self.fused_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "ops": dict(self.ops),
            "routes": {k: dict(v) for k, v in self.routes.items()},
            "peak_bytes": self.peak_bytes,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.peak_bytes - self.argument_bytes,
            "peak_live": self.peak_live(),
        }
