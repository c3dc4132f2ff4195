"""Program accounting of one rank's step: FLOPs, HBM bytes and collective
traffic (port of ``launch/hlo_analysis.py``).

JAX's module parses a compiled program's HLO text.  The port has no HLO:
``count_program`` counts a traced run of the port's per-rank program
instead.  The step runs once under a ``TorchDispatchMode`` (on ``meta``
tensors for a dry rank, ``launch.mesh.dry_rank``, or on real ones) and
three things are added up:

* **FLOPs**, from ``torch.utils.flop_counter``'s registry (2·m·n·k a
  matmul, the convolutions, SDPA), an op with a composite kernel
  decomposed first, as ``FlopCounterMode`` counts them, plus the work that
  a hand-written kernel's dispatcher reports (``kernels._build.
  report_work``), since a dispatch trace cannot see inside a kernel
  launched through ``ctypes``;
* **HBM bytes**, as the input plus output bytes of every aten op that is
  not a view: eager mode runs each op as its own kernel, which is JAX's
  "post-fusion buffer level" for this program.  An allocation
  (``empty``) moves nothing, an in-place op's output is its input (counted
  once), a copy between devices (a host constant sent over) is a
  transfer, and the process-group ops are the collectives' own entries; on a
  live gloo rank the copies that stage a CUDA tensor through host memory
  count, which a dry rank does not make;
* **collectives**, from the mesh's counter (``ModelMesh.calls``, or a dry
  ``ShardGroup``'s: calls and input bytes by kind and group size),
  converted here, in one place, to JAX's convention: the **result** bytes
  of each collective, keyed ``"all-reduce"``, ``"all-gather"``,
  ``"reduce-scatter"``, ``"all-to-all"`` and ``"collective-permute"``, with
  wire bytes = result bytes × ``_wire_factor``.

JAX's HLO parser (``parse_module``, ``execution_multipliers``,
``_trip_count``, the fusion-byte heuristics) has no counterpart: the
port's layers run as a Python loop, so each iteration is counted as it
runs; ``flops_unscaled`` equals ``flops`` and ``loop_trip_max`` is 1.
``trace_program`` also returns the peak of the live storage bytes the run
allocated beyond its arguments (weak references to storages), what
``launch/dryrun.py`` reports as ``temp_bytes``.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, NamedTuple, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the mesh counter's kind names (``models/collectives.py``) → JAX's
_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "collective_permute": "collective-permute"}

# allocations: no data moves
_ALLOC = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
          torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


@dataclass
class ProgramStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_counts: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_bytes_alg: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_bytes_wire: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    flops_unscaled: float = 0.0     # = flops: each loop iteration is counted as it runs
    loop_trip_max: float = 1.0

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.coll_bytes_wire.values())

    def as_dict(self) -> Dict:
        return {
            "flops": float(self.flops),
            "flops_unscaled": float(self.flops_unscaled),
            "hbm_bytes": float(self.hbm_bytes),
            "collective_counts": {k: float(v) for k, v in self.coll_counts.items()},
            "collective_bytes_alg": {k: float(v) for k, v in self.coll_bytes_alg.items()},
            "collective_bytes_wire": {k: float(v) for k, v in self.coll_bytes_wire.items()},
            "total_wire_bytes": float(self.total_wire_bytes),
        }


@dataclass
class CollectiveStats:
    counts: Dict[str, float]
    bytes_alg: Dict[str, float]
    bytes_wire: Dict[str, float]

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.bytes_wire.values())

    def as_dict(self) -> Dict:
        return {
            "counts": dict(self.counts),
            "bytes_alg": dict(self.bytes_alg),
            "bytes_wire": dict(self.bytes_wire),
            "total_wire_bytes": float(self.total_wire_bytes),
        }


def _wire_factor(op: str, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-gather":
        return (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)  # result is the 1/g shard
    if op == "all-to-all":
        return (g - 1) / g
    return 1.0  # collective-permute


def collective_stats(calls: Mapping[Tuple[str, int], Tuple[int, int]]) -> CollectiveStats:
    """JAX's collective entries from a mesh's ``calls`` ({(kind, group
    size): (calls, input bytes)}): an all-gather's result is g times its
    input, a reduce-scatter's 1/g, the others' their input."""
    counts: Dict[str, float] = defaultdict(float)
    alg: Dict[str, float] = defaultdict(float)
    wire: Dict[str, float] = defaultdict(float)
    for (kind, g), (n, nbytes) in calls.items():
        op = _KIND[kind]
        result = nbytes * g if op == "all-gather" else \
            nbytes // g if op == "reduce-scatter" else nbytes
        counts[op] += n
        alg[op] += result
        wire[op] += result * _wire_factor(op, g)
    return CollectiveStats(counts=dict(counts), bytes_alg=dict(alg), bytes_wire=dict(wire))


def storages(tree) -> Dict[int, int]:
    """``{storage: bytes}`` of every tensor in ``tree`` (tensors, modules,
    dicts, lists, tuples and named tuples), each storage once."""
    out: Dict[int, int] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(x, torch.nn.Module):
            for t in (*x.parameters(), *x.buffers()):
                walk(t)
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd


class _Trace(TorchDispatchMode):
    """FLOPs of the registry's ops, bytes in and out of every aten op that
    is not a view or an allocation, and the live storage bytes the run
    allocated, with their peak; the storages of ``known`` (the arguments)
    are not counted.  An op with a composite kernel is decomposed and its
    parts counted, as ``FlopCounterMode`` does."""

    def __init__(self, known: Set[int]):
        super().__init__()
        self.known = known
        self.flops = 0
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, int] = {}
        self._composite: Dict[Any, bool] = {}

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self._tracked:
            return
        self._tracked[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite = self._composite.get(func)
        if composite is None:
            composite = self._composite[func] = (
                _COMPOSITE in func.py_kernels
                or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _COMPOSITE))
        if composite:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        if not outs:
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self._track(t)
        if func.is_view or func._overloadpacket in _ALLOC or "c10d" in func.namespace:
            return out
        ins = _tensors((args, kwargs), [])
        if any(t.device != outs[0].device for t in ins):
            return out   # a transfer between devices (a host constant), not a pass over HBM
        seen = {t.untyped_storage()._cdata for t in ins}
        self.hbm_bytes += sum(t.nbytes for t in ins)
        self.hbm_bytes += sum(t.nbytes for t in outs if t.untyped_storage()._cdata not in seen)
        return out


class Traced(NamedTuple):
    out: Any                 # what the program returned
    stats: ProgramStats
    temp_bytes: int          # peak live storage bytes beyond the arguments


def trace_program(fn: Callable, *args, mesh=None) -> Traced:
    """Run ``fn(*args)`` once under the counting modes; the collectives are
    the ``mesh``'s calls during the run (none without a mesh)."""
    before = dict(mesh.calls) if mesh is not None else {}
    sink = [0.0, 0.0]
    trace = _Trace(set(storages(args)))
    _build.WORK_SINKS.append(sink)
    try:
        with trace:
            out = fn(*args)
    finally:
        _build.WORK_SINKS.remove(sink)
    st = ProgramStats()
    st.flops = st.flops_unscaled = float(trace.flops + sink[0])
    st.hbm_bytes = float(trace.hbm_bytes + sink[1])
    if mesh is not None:
        calls = {k: (n - before.get(k, (0, 0))[0], b - before.get(k, (0, 0))[1])
                 for k, (n, b) in mesh.calls.items() if (n, b) != before.get(k)}
        coll = collective_stats(calls)
        st.coll_counts.update(coll.counts)
        st.coll_bytes_alg.update(coll.bytes_alg)
        st.coll_bytes_wire.update(coll.bytes_wire)
    return Traced(out=out, stats=st, temp_bytes=trace.peak)


def count_program(fn: Callable, *args, mesh=None) -> ProgramStats:
    """The FLOPs, HBM bytes and collective traffic of ``fn(*args)`` on this
    rank (``trace_program``'s stats)."""
    return trace_program(fn, *args, mesh=mesh).stats
