"""The traced run's readings: profiled sub-windows and one under sync
debug mode, reduced to what the per-layer readers and ``breakdown`` need.

The profiler's timeline is read from its Chrome trace: device intervals
are the events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``;
the sub-window is the ``perfbench.window`` annotation around it, widened
to every device interval the trace holds; an idle gap is labelled with
the innermost host operator running at its middle."""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import warnings
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"
#: a kernel's name in ``breakdown`` is cut to this many characters
NAME_CHARS = 120


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The merged intervals clipped to [lo, hi], in order."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


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


def read_trace(events: List[dict]) -> Dict:
    """Window, busy time, kernel count and time, and the breakdown, from
    the Chrome trace's events (times in µs)."""
    (win,) = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    # the profiler records the window's work alone; the device's clock may
    # lie a little off the host's, so the window takes in all of it
    lo = min([float(win["ts"])] + [a for a, _ in spans])
    hi = max([float(win["ts"]) + float(win["dur"])] + [b for _, b in spans])
    busy = _union(spans, lo, hi)
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    tid = win.get("tid")
    cpu_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"
               and e.get("tid") == tid]
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, _labels(cpu_ops, [(a + b) / 2 for a, b in idle])):
        gaps[name] += (b - a) * 1e-6

    def top(d):
        return [[k if len(k) <= NAME_CHARS else k[:NAME_CHARS - 3] + "...", v]
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return dict(window_s=(hi - lo) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernel_count=len(kernels),
                kernel_s=sum(float(e["dur"]) for e in kernels) * 1e-6,
                breakdown={"device_ops": top(by_name), "idle_gaps": top(gaps)})


@contextlib.contextmanager
def tracing() -> Iterator[Dict]:
    """Profile the code inside, in a ``WINDOW`` annotation that ends once
    the card has synchronised; the dict it yields receives the readings of
    ``read_trace`` on the way out.  On a card the profiler records its
    kernels, copies and fills too."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    out: Dict = {}
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        with record_function(WINDOW):
            yield out
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(read_trace(events))


def profiled(work: Callable[[], int]) -> Dict:
    """Run ``work`` (which returns the outer iterations it ran) under the
    profiler; its readings."""
    with tracing() as out:
        outers = work()
    out["outers"] = outers
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
