"""Op counting for the port: the counterpart of ``repro.launch.hlo_analysis``.

The JAX package reads FLOPs and bytes from the optimized HLO of a compiled
step, weighting while-loop bodies by their trip counts. The port has no
compiler: :class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten
op of an eager step as it is dispatched (a Python loop dispatches every
iteration's ops, so there are no trip counts to recover), on real tensors
or on fake ones (``launch/dryrun.py``), and accumulates:

  * FLOPs — each op's by ``torch.utils.flop_counter``'s registered formulas
    (matmuls, convolutions, attention; 0 for elementwise ops),
  * bytes — each aten op's operands plus outputs, the same upper bound on
    memory traffic that ``hlo_analysis`` takes: views and allocations move
    none (HLO's bitcasts and parameters), an indexed read or write moves the
    elements it touches (HLO's dynamic-slice and dynamic-update-slice), and
    an operand counts at most its storage's bytes (a broadcast view is read
    once),
  * the peak of live tensor bytes — each new storage counted from the op
    that made it until a finalizer sees it freed, over the tensors handed
    in as live at the start,
  * kernel launches — each hand-written kernel once a call, by its cost
    function (``repro_torch.kernels.Cost``), whichever route computes it;
    the aten ops inside a plain version are not counted, so one step counts
    the same on the CPU, on the card and on fake tensors,
  * collectives — each ``_c10d_functional`` collective (and DTensor's
    ``shard_dim_alltoall``) by kind, with the bytes of its output: the
    gathered buffer of an all-gather, the reduced one of an all-reduce, the
    rank's shard of a reduce-scatter (``hlo_analysis``'s result-shape rule);
    the peak adds the copy of its input an all-to-all holds while it runs.
    Point-to-point sends do not pass the dispatcher: the gossip reports
    them (:meth:`OpCounter.count_collective`, kind ``collective-permute``,
    the JAX roofline's name for a ppermute; the bytes sent).

On a mesh every count is one rank's. A dispatch mode sees a DTensor op once,
at global shapes, and not the local ops and collectives DTensor issues for
it; the counter defers such an op to DTensor (returns ``NotImplemented``),
whose local ops and collectives then come back to it on the rank's own
tensors. Live DTensors count their local shards. DTensor also runs an op
once on fake tensors of the global shapes to learn its output's shape (the
first time it sees the op's placements); the counter ignores those runs.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from collections import Counter
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import kernels

_aten = torch.ops.aten
# ops that allocate or alias and move no bytes (HLO's parameter, bitcast)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten._unsafe_view.default,
               _aten.lift_fresh.default}
# indexed reads and writes move the elements they touch, not the tensor they
# index (HLO's dynamic-slice and dynamic-update-slice rules)
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default}
_SCATTERS = {_aten.index_put_.default, _aten.index_put.default,
             _aten._index_put_impl_.default, _aten.scatter_.src, _aten.scatter.src,
             _aten.scatter_add_.default, _aten.scatter_add.default,
             _aten.index_copy_.default, _aten.index_add_.default}


def tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors in nested dicts, lists, tuples and dataclasses."""
    if isinstance(obj, DTensor):
        yield obj.to_local()
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))


@dataclasses.dataclass
class OpStats:
    """What an :class:`OpCounter` saw. ``flops`` and ``bytes`` include the
    kernels' costs; ``launches`` counts the kernels by name."""

    flops: float = 0.0
    bytes: float = 0.0
    flops_by_op: Counter = dataclasses.field(default_factory=Counter)
    bytes_by_op: Counter = dataclasses.field(default_factory=Counter)
    calls_by_op: Counter = dataclasses.field(default_factory=Counter)
    launches: Counter = dataclasses.field(default_factory=Counter)
    collectives: Counter = dataclasses.field(default_factory=Counter)  # kind -> calls
    collective_bytes: Counter = dataclasses.field(default_factory=Counter)  # kind -> bytes
    start_bytes: int = 0  # live bytes handed in at the start
    peak_bytes: int = 0  # the most live bytes at once

    def top(self, n: int = 8) -> Dict[str, float]:
        """The ``n`` ops (kernels included) with the most FLOPs."""
        return dict(self.flops_by_op.most_common(n))


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, peak live bytes and kernel launches of what runs
    under it (see the module docstring). ``live``: the tensors alive at the
    start whose bytes the peak counts (a state, a batch); ``device``: count
    only storages on this device type for the peak (None: every one)."""

    def __init__(self, live: Any = (), device: Optional[str] = None) -> None:
        super().__init__()
        self.stats = OpStats()
        self.device = device
        # id(storage) -> (its allocation [bytes, storage objects on it], weakref)
        self._live: Dict[int, Tuple[List[int], Any]] = {}
        self._bytes = 0
        self._depth = 0  # > 0 inside a kernel's call (kernels.kernel_call)
        self._shadow = 0  # > 0 inside DTensor's shape propagation
        self._patched = None
        for t in tensors(live):
            self._track(t)
        self.stats.start_bytes = self.stats.peak_bytes = self._bytes

    # -- DTensor's shape propagation --------------------------------------------------
    def __enter__(self):
        meta = getattr(ShardingPropagator, _PROPAGATE, None)
        if meta is not None and self._patched is None:
            counter = self

            @functools.wraps(meta)
            def shadowed(*args, **kwargs):
                counter._shadow += 1
                try:
                    return meta(*args, **kwargs)
                finally:
                    counter._shadow -= 1

            setattr(ShardingPropagator, _PROPAGATE, shadowed)
            self._patched = meta
        return super().__enter__()

    def __exit__(self, *exc):
        if self._patched is not None:
            setattr(ShardingPropagator, _PROPAGATE, self._patched)
            self._patched = None
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------------
    def _track(self, t: torch.Tensor, alias_of: Optional[torch.Tensor] = None,
               compact: bool = False) -> None:
        """Count ``t``'s storage from now until it is freed; with
        ``alias_of``, a storage object that holds the same memory as that
        tensor's (a collective's wait on a fake tensor gives a new one),
        counted once for both; ``compact``: count t's own bytes, not its
        storage's (DTensor's fake all-to-all returns a slice of a buffer
        ``group size`` times larger, where the card allocates the slice)."""
        if self.device is not None and t.device.type != self.device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        base = self._live.get(id(alias_of.untyped_storage())) if alias_of is not None else None
        if base is not None:
            alloc = base[0]
            alloc[1] += 1
        else:
            alloc = [_nbytes(t) if compact else st.nbytes(), 1]
            self._bytes += alloc[0]
            if self._bytes > self.stats.peak_bytes:
                self.stats.peak_bytes = self._bytes
        # the storage's Python object lives as long as its storage
        self._live[key] = (alloc, weakref.ref(st, functools.partial(self._free, key)))

    def _free(self, key: int, _ref: Any = None) -> None:
        alloc, _ = self._live.pop(key, ([0, 1], None))
        alloc[1] -= 1
        if not alloc[1]:
            self._bytes -= alloc[0]

    @property
    def live_bytes(self) -> int:
        return self._bytes

    # -- kernels -------------------------------------------------------------------
    def enter_kernel(self, name: str, cost: Optional[kernels.Cost]) -> None:
        self._depth += 1
        if cost is not None:
            st = self.stats
            st.launches[name] += 1
            st.flops += cost.flops
            st.bytes += cost.bytes
            st.flops_by_op[name] += cost.flops
            st.bytes_by_op[name] += cost.bytes
            st.calls_by_op[name] += 1

    def exit_kernel(self) -> None:
        self._depth -= 1

    # -- what the dispatcher does not see ------------------------------------------------
    def count_collective(self, kind: str, calls: int, n_bytes: float) -> None:
        """``calls`` transfers of ``n_bytes`` in all that bypass the
        dispatcher (the gossip's point-to-point sends)."""
        self.stats.collectives[kind] += calls
        self.stats.collective_bytes[kind] += n_bytes

    def enter_op(self, name: str, n_bytes: float) -> None:
        """One aten op ``name`` moving ``n_bytes``, counted whole: the ops it
        dispatches until :meth:`exit_kernel` are not (see
        :class:`repro_torch.kernels.whole_op`)."""
        self._depth += 1
        st = self.stats
        st.bytes += n_bytes
        st.bytes_by_op[name] += n_bytes
        st.calls_by_op[name] += 1

    # -- aten ops --------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor's local ops and collectives come back here
        kwargs = kwargs or {}
        if self._shadow:  # DTensor learning an output's global shape
            return func(*args, **kwargs)
        info = _info(func)
        if info.composite and torch.is_inference_mode_enabled():
            # autograd decomposes a composite op (matmul, to, reshape)
            # before it reaches a mode; under inference mode it arrives
            # whole: count its parts
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = _flat(out)
        if info.alias:  # a collective's wait: its output is its input's memory
            for t in outs:
                self._track(t, alias_of=_flat(args)[0])
        elif outs and not info.view:
            ins = _flat(args) + _flat(kwargs.values())
            # a new storage is an allocation; an in-place op or an out=
            # argument hands back one of its inputs' storages
            seen = {id(t.untyped_storage()) for t in ins} if info.mutable else ()
            for t in outs:
                if not seen or id(t.untyped_storage()) not in seen:
                    self._track(t, compact=info.collective is not None)
        if info.collective is not None:
            st = self.stats
            st.collectives[info.collective] += 1
            st.collective_bytes[info.collective] += sum(_nbytes(t) for t in outs)
            if info.name == "shard_dim_alltoall":
                # the card's implementation holds one more copy of the input
                # (its chunks made contiguous) beside the output while it runs
                st.peak_bytes = max(st.peak_bytes, self._bytes + _nbytes(_flat(args)[0]))
        if self._depth == 0:
            st = self.stats
            st.calls_by_op[info.name] += 1
            if info.formula is not None:
                flops = info.formula(*args, **kwargs, out_val=out)
                st.flops += flops
                st.flops_by_op[info.name] += flops
            if info.traffic:
                ins = _flat(args) + _flat(kwargs.values())
                if func in _GATHERS:  # the indices, and the gathered elements twice
                    n_bytes = (sum(_read_bytes(t) for t in ins[1:])
                               + 2 * sum(_nbytes(t) for t in outs))
                elif func in _SCATTERS:  # the indices and the source, written once more
                    n_bytes = sum(_read_bytes(t) for t in ins[1:]) + _nbytes(ins[-1])
                else:
                    n_bytes = (sum(_read_bytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))
                st.bytes += n_bytes
                st.bytes_by_op[info.name] += n_bytes
        return out


class _OpInfo(NamedTuple):
    name: str
    formula: Any  # flop_registry's, or None
    view: bool  # the outputs alias an input
    mutable: bool  # in place, or an out= argument
    traffic: bool  # moves bytes (not a view or a bare allocation)
    composite: bool  # has a CompositeImplicitAutograd decomposition
    collective: Optional[str]  # the collective's kind (roofline's names), or None
    alias: bool  # the output is the input's memory (a collective's wait)


@functools.lru_cache(maxsize=None)
def _info(func) -> _OpInfo:
    packet = func.overloadpacket
    formula = flop_registry.get(packet)
    composite = (func.namespace == "aten" and formula is None
                 and torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
    view = bool(func.is_view)
    traffic = func.namespace == "aten" and not view and func not in _NO_TRAFFIC
    key = (func.namespace, packet.__name__)
    return _OpInfo(packet.__name__, formula, view, bool(func._schema.is_mutable), traffic,
                   composite, _COLLECTIVES.get(key), key in _ALIASES)


# the ShardingPropagator method that runs an op on global fake tensors
_PROPAGATE = "_propagate_tensor_meta_non_cached"

# the collectives a rank issues, by (namespace, op), named as the JAX
# roofline's HLO kinds
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("_c10d_functional_autograd", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional_autograd", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional_autograd", "all_to_all_single"): "all-to-all",
}
# ops whose output is their input's memory: a collective's wait, and the
# wrapper that defers it (a fake tensor's wait gives a new storage object)
_ALIASES = {("_c10d_functional", "wait_tensor"), ("_c10d_functional", "_wrap_tensor_autograd")}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read_bytes(t: torch.Tensor) -> int:
    """An operand's bytes, read once: an expanded (stride-0) view reads no
    more than its storage."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _flat(xs: Any) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs (lists one level deep)."""
    if isinstance(xs, torch.Tensor):
        return [xs]
    if not isinstance(xs, (list, tuple, type({}.values()))):
        return []
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out
