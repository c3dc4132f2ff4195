"""The traced run's readings: a profiled sub-window and one under sync
debug mode, reduced to what the per-layer readers and ``breakdown`` need.

The profiler's timeline is read from its Chrome trace.  Device intervals
are the events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``.
The steady interval is the union of the program's ``shard.outer`` spans
(``user_annotation`` events on the thread that runs the work): it leaves
out each solve's start, its result and the gaps between solves.  The busy
time is the union of the device intervals clipped to it, so it never
passes the interval's length.  A device event counts for the kernel
count, the kernel time and ``device_ops`` where its launch (the runtime
call of the same correlation id) lies in the interval, or, with no launch
in the trace, where it starts there.  A trace without ``shard.outer``
spans reads over its ``perfbench.window`` annotations instead, from the
first one's start to the last one's end, widened to every device interval
the trace holds.  An idle gap is labelled with the innermost host
operator running at its middle."""
from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import tempfile
import warnings
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host-side events that carry a device event's launch
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"
#: the program's span around one outer iteration (``repro_torch.core.spans``)
OUTER = "shard.outer"
#: a kernel's name in ``breakdown`` is cut to this many characters
NAME_CHARS = 120

Intervals = List[Tuple[int, int]]


def _ns(t) -> int:
    """A trace time in µs as whole nanoseconds, so that sums of intervals
    are exact and a part never sums past its whole."""
    return round(float(t) * 1000)


def _merge(intervals) -> Intervals:
    """The union of ``intervals``, merged, in order."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _intersect(xs: Intervals, ys: Intervals) -> Intervals:
    """The intersection of two merged lists of intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _holes(within: Intervals, busy: Intervals) -> Intervals:
    """The parts of ``within`` that ``busy`` (a subset of it) leaves free."""
    out = []
    for a, b in within:
        edge = a
        for c, d in _intersect([(a, b)], busy):
            if c > edge:
                out.append((edge, c))
            edge = d
        if b > edge:
            out.append((edge, b))
    return out


def _covers(intervals: Intervals, t: int) -> bool:
    """Whether ``t`` lies in one of the merged ``intervals``."""
    i = bisect.bisect_right(intervals, (t, math.inf)) - 1
    return i >= 0 and t < intervals[i][1]


def _labels(cpu_ops: List[Tuple[float, float, str]], times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the innermost host operator
    running then: the operators of one thread nest, so a stack of the open
    ones, swept forward in time, holds it on top."""
    ops = sorted(cpu_ops, key=lambda o: (o[0], -o[1]))
    stack: List[Tuple[float, float, str]] = []
    out, j = [], 0
    for t in times:
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host, outside any operator")
    return out


def _span(e: dict) -> Tuple[int, int]:
    a = _ns(e["ts"])
    return a, a + _ns(e["dur"])


def read_trace(events: List[dict]) -> Dict:
    """The steady interval's length (``window_s``), the device's busy time
    in it, the outer iterations it holds (``outers``; None without
    ``shard.outer`` spans), the kernel count and time, and the breakdown,
    from the Chrome trace's events (times in µs)."""
    def annotations(name):
        return [e for e in events if e.get("name") == name and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"]

    wins = annotations(WINDOW)
    if not wins:
        raise ValueError(f"the trace holds no {WINDOW!r} annotation")
    tid = wins[0].get("tid")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    outer = [_span(e) for e in annotations(OUTER) if e.get("tid") == tid]
    if outer:
        steady = _merge(outer)
        launched = {e["args"]["correlation"]: _ns(e["ts"]) for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in (e.get("args") or {})}
        mine = [e for e in dev if _covers(steady, launched.get(
            (e.get("args") or {}).get("correlation"), _ns(e["ts"])))]
    else:
        # the device's clock may lie a little off the host's, so the
        # window takes in all of the session's device work
        ends = [_span(e) for e in wins + dev]
        steady = [(min(a for a, _ in ends), max(b for _, b in ends))]
        mine = dev
    busy = _intersect(steady, _merge(_span(e) for e in dev))
    kernels = [e for e in mine if e["cat"] == "kernel"]
    by_name: Dict[str, float] = defaultdict(float)
    for e in mine:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    cpu_ops = [(_ns(e["ts"]), _ns(e["ts"]) + _ns(e["dur"]), e["name"])
               for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"
               and e.get("tid") == tid]
    idle = _holes(steady, busy)
    gaps: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, _labels(cpu_ops, [(a + b) / 2 for a, b in idle])):
        gaps[name] += (b - a) * 1e-9

    def top(d):
        return [[k if len(k) <= NAME_CHARS else k[:NAME_CHARS - 3] + "...", v]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(window_s=sum(b - a for a, b in steady) * 1e-9,
                busy_s=sum(b - a for a, b in busy) * 1e-9,
                outers=len(outer) or None,
                kernel_count=len(kernels),
                kernel_s=sum(float(e["dur"]) for e in kernels) * 1e-6,
                breakdown={"device_ops": top(by_name), "idle_gaps": top(gaps)})


@contextlib.contextmanager
def tracing() -> Iterator[Dict]:
    """Profile the code inside, which opens ``window()`` around its work;
    the dict it yields receives the readings of ``read_trace`` on the way
    out.  On a card the profiler records its kernels, copies and fills
    too."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    out: Dict = {}
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        yield out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(read_trace(events))


@contextlib.contextmanager
def window() -> Iterator[None]:
    """A ``WINDOW`` annotation around work under ``tracing()``, which ends
    once the current card has synchronised."""
    from torch.profiler import record_function

    with record_function(WINDOW):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def profiled(work: Callable[[], int]) -> Dict:
    """Run ``work`` (which returns the outer iterations it ran) under the
    profiler, in one window; its readings.  Where the trace holds the
    program's outer spans, their count must be the work's: otherwise the
    spans no longer cover the loop, and the readings would not hold."""
    with tracing() as out:
        with window():
            outers = work()
    if out["outers"] is None:
        out["outers"] = outers
    elif out["outers"] != outers:
        raise RuntimeError(f"the trace holds {out['outers']} {OUTER!r} spans where the work "
                           f"ran {outers} outer iterations")
    return out


def count_syncs(work: Callable[[], int]) -> Tuple[int, int]:
    """(synchronising calls, outer iterations) of ``work`` under
    ``torch.cuda.set_sync_debug_mode("warn")``.  The mode is switched on
    before the warnings are recorded: switching it gives torch's one-time
    notice that the mode is a prototype, which is no sync."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outers = work()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing" in str(w.message) for w in caught)
    return n, outers
