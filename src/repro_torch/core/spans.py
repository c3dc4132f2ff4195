"""The port's spans and counters: where the shard runtimes' time and work go.

A span names one phase of a solve.  It costs a flag check and nothing
else unless one of two things watches:

* a ``torch.profiler`` that records: the span enters
  ``torch.profiler.record_function(name)``, so it lies in the profiler's
  trace as a ``user_annotation`` on the host thread that launched the
  phase's kernels, on the clock of the device's kernels;
* a recorder opened by ``recording()``: the span appends a ``Record`` to
  it (name, start and end from its clock, its parent span, and the
  sequence number its root span opened: the spans of one solve share
  one).

The runtimes open one span per phase over all their local shards, never
one per shard: an outer iteration of the 256-shard solve holds seven
spans, where one a shard and phase would be over a thousand.

Counters (``COUNTERS``) add up only while a recorder is open, in its
``counts``.  The kernels' own work needs no counter here: every launch of
the stencil and diff-norm kernels reports its operations and bytes to
``kernels._build.WORK_SINKS``, which a caller opens beside a recorder.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

#: every span name, with its layer and what it covers
NAMES: Dict[str, str] = {
    "shard.solve": "shard loop: a runtime's whole ``run``, placement to result",
    "shard.result": "shard loop: the result's gather, concatenation and host reads",
    "shard.outer": "shard loop: one outer iteration; its wall less shard.sync's "
                   "is the host's dispatch an iteration",
    "shard.sweeps": "shard loop: the inner sweeps of every local shard (with "
                    "overlap, also the new faces and their shipping)",
    "shard.contrib": "shard loop: the last sweep with its detection contribution",
    "shard.exact": "shard loop: the blocking reduction's residual-only pass",
    "shard.exchange": "shard loop: the halo exchange (or its wait) and the ring write",
    "shard.reduce": "monitor: the contribution lanes, a butterfly round, the "
                    "reduction's launch",
    "shard.decide": "monitor: the reduction consumed and the detection rule",
    "shard.sync": "monitor: the host's read of ``converged``, its wait for the card",
}

#: every counter name, with its layer and what it counts
COUNTERS: Dict[str, str] = {
    "host_syncs": "monitor: each read of a device value on the host "
                  "(``host_read``): one a check, NFAIS2's flag, the result's",
    "ghost_bytes": "shard loop: bytes written into a ghosted block by its "
                   "assembly (a fresh block's zero fill, the interior, the faces)",
    "wire_bytes": "transport: payload bytes a live group's rank hands to its "
                  "backend: each reduction's lane (``reduce``, ``exact``) and each "
                  "message ``route`` sends; not the result's ``all_gather``",
    "collectives": "transport: backend operations a live group's rank launches: "
                   "one an ``all_reduce``, one each ``isend`` and ``irecv`` of a "
                   "``route``'s batch",
}


class Record(NamedTuple):
    """One closed span: its clock's start and end, the index of its parent
    record (-1 at the root) and the sequence number of its root span."""

    name: str
    start: int
    end: int
    parent: int
    seq: int


@dataclass
class Recorder:
    """The spans and counts of one ``recording()``: ``records`` in the
    order their spans opened (None while one is open)."""

    clock: Callable[[], int] = time.perf_counter_ns
    records: List[Optional[Record]] = field(default_factory=list)
    counts: Counter = field(default_factory=Counter)
    _open: List[tuple] = field(default_factory=list)
    _seq: int = -1

    def _enter(self, name: str) -> None:
        parent = self._open[-1][0] if self._open else -1
        if parent < 0:
            self._seq += 1
        self._open.append((len(self.records), name, parent, self._seq, self.clock()))
        self.records.append(None)

    def _exit(self) -> None:
        end = self.clock()
        idx, name, parent, seq, start = self._open.pop()
        self.records[idx] = Record(name, start, end, parent, seq)

    def totals(self) -> Dict[str, Dict[str, float]]:
        """For each span name: ``count``, ``seconds`` (summed durations) and
        ``self_seconds`` (durations less the parts their child spans
        cover), over the closed spans."""
        child: Dict[int, int] = defaultdict(int)
        for r in self.records:
            if r is not None and r.parent >= 0:
                child[r.parent] += r.end - r.start
        out: Dict[str, Dict[str, float]] = {}
        for idx, r in enumerate(self.records):
            if r is None:
                continue
            t = out.setdefault(r.name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0})
            t["count"] += 1
            t["seconds"] += (r.end - r.start) * 1e-9
            t["self_seconds"] += (r.end - r.start - child[idx]) * 1e-9
        return out


_RECORDER: Optional[Recorder] = None
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def recording(clock: Callable[[], int] = time.perf_counter_ns) -> Iterator[Recorder]:
    """Open a recorder for the spans and counts of the code run inside;
    ``clock`` gives integer nanoseconds.  One recorder at a time."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a recorder is already open")
    _RECORDER = rec = Recorder(clock)
    try:
        yield rec
    finally:
        _RECORDER = None


class _Span:
    __slots__ = ("name", "_fn", "_rec")

    def __init__(self, name: str):
        self.name, self._fn, self._rec = name, None, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self._rec = _RECORDER
        if self._rec is not None:
            self._rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._exit()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one phase, named in ``NAMES``: the shared
    null context unless a profiler records or a recorder is open."""
    if _RECORDER is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def counting() -> bool:
    """True while a recorder is open: a caller whose count costs work to
    reckon asks first."""
    return _RECORDER is not None


def count(name: str, n: int) -> None:
    """Add ``n`` to the open recorder's counter ``name`` (``COUNTERS``);
    nothing without one."""
    if _RECORDER is not None:
        _RECORDER.counts[name] += n


def host_read(t: torch.Tensor):
    """The value of the one-element tensor ``t`` on the host (``t.item()``:
    a bool or an int for the monitor's flags and counters), counted as a
    host sync: on the card the host waits here for every kernel queued
    before."""
    count("host_syncs", 1)
    return t.item()
