"""One run of one cell: set-up, the measured window, the traced
sub-windows, and the comparison with the plain reference that decides
``correct``.

The window is a closed loop of solves through the program's runtime
(``make_runtime``'s ``run(x0, arg)``), built in set-up and warmed up.
Each solve's ``max_outer`` is the mix's, capped at the outer iterations
left in the window at the rate the second warm-up measured, so a solve
near the end is cut by the window.  Set-up builds the runtime of the
window's first solve; a later solve with a new cap builds its own
(``make_runtime``: closures over the configuration, nothing to compile)
inside the window.  The window closes at the first return after
``seconds``.  ``memory_peak_bytes`` is the program's: each solve's peak
less the states of earlier solves that the harness holds for the check.

After the window (``memory_peak_bytes`` read first, the program's state
freed), the reference is run on the same inputs:

* every detection's exact residual must be under ε̃, the guarantee, to
  the rounding of the monitor's float32 values (the limit of
  ``r_over_eps``);
* a sample of the solves (drawn from the seed, the longest always in it)
  is solved again by the plain reference: the outer iteration it stops
  at and whether it converged, its state and the monitor's series."""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import profile, spec
from perfbench.traffic import Mix

#: the profiled pair of sub-windows, the short one at least this many outer
#: iterations and seconds, the long one twice that.  A reading is the long
#: one's less the short one's, so a solve's start and its result, which a
#: capped solve holds more of than the window's, drop out.
PROFILE_OUTER, PROFILE_S = 4, 0.5
#: the sub-window under sync debug mode: whole solves, as the window runs
#: them, for at least this many seconds
SYNC_S = 1.0


@dataclass
class Solve:
    index: int
    max_outer: int
    outer: int
    converged: bool
    cut: bool
    wall: float
    x: Optional[torch.Tensor]
    trace: torch.Tensor


@dataclass
class Run:
    """What a run measured and compared."""

    setup_s: float
    window_s: float
    solves: List[Solve]
    memory_peak: int
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    failed: int = 0
    traced: Optional[Dict] = None
    #: seconds of each stage of set-up, in order
    setup_stages: Dict[str, float] = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program's runtime for a cell, one build for each ``max_outer``
    it is asked for (the mix's, the warm-up's, a cap)."""

    def __init__(self, prob, inputs: Callable):
        self.prob, self.inputs = prob, inputs
        self._built: Dict[int, Callable] = {}

    def build(self, max_outer: int) -> Callable:
        if max_outer not in self._built:
            self._built[max_outer] = self.prob.runtime(max_outer)
        return self._built[max_outer]

    def run(self, index: int, max_outer: int, device: torch.device) -> Solve:
        """Solve ``index``: its inputs drawn, then the timed call."""
        x0, arg = self.inputs(index)
        _sync(device)
        t0 = time.perf_counter()
        res = self.build(max_outer)(x0, arg)
        _sync(device)
        wall = time.perf_counter() - t0
        k = int(res.outer_iters)
        return Solve(index, max_outer, k, bool(res.converged),
                     cut=not res.converged and max_outer < self.prob.mix.max_outer,
                     wall=wall, x=res.x, trace=res.trace[:k])

    def free(self) -> None:
        self._built.clear()


def _cap(mix: Mix, seconds: float, rate: float) -> int:
    """A solve's ``max_outer`` with ``seconds`` of the window left."""
    return min(mix.max_outer, max(1, math.ceil(seconds / rate)))


def _window(program: Program, mix: Mix, seconds: float, rate: float, first: int,
            device: torch.device, keep_all: bool):
    """The closed loop: solves ``first``, ``first + 1``, … until the first
    return after ``seconds``; (solves, wall, the program's peak bytes).  A
    solve's state is kept for the check where it has a detection to
    certify, where ``keep_all``, or where it is the longest so far (the one
    sample that is always drawn)."""
    cuda = device.type == "cuda"
    solves: List[Solve] = []
    peak = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    now = t0
    while now < end:
        if cuda:
            held = sum(t.x.numel() * t.x.element_size() for t in solves if t.x is not None)
            torch.cuda.reset_peak_memory_stats(device)
        s = program.run(first + len(solves), _cap(mix, end - now, rate), device)
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated(device) - held)
        if not (keep_all or s.converged or s.outer > max((t.outer for t in solves), default=-1)):
            s.x = None
        solves.append(s)
        now = time.perf_counter()
    return solves, now - t0, peak


def _sample(solves: List[Solve], count: int, seed: int) -> List[Solve]:
    """``count`` solves drawn from ``seed``, the one of most outer
    iterations always among them."""
    longest = max(solves, key=lambda s: s.outer)
    rest = [s for s in solves if s is not longest]
    rng = random.Random(seed)
    return [longest] + rng.sample(rest, min(len(rest), max(count - 1, 0)))


def _check(prob, solves: List[Solve], limits: Dict, seed: int, count: int) -> tuple:
    """Compare with the plain reference; (checks, failed)."""
    r_max, false_det = 0.0, 0
    for s in solves:
        if s.converged:
            r = prob.exact_residual(s.index, s.x) / prob.eps_tilde
            r_max = max(r_max, r)
            false_det += not r < limits["r_over_eps"]
    unconverged = sum(not s.converged and not s.cut for s in solves)
    sample = _sample(solves, count, seed)
    for s in solves:   # only the sample's states are needed from here
        if not any(s is t for t in sample):
            s.x = None
    stop_gap, x_gap, trace_gap = 0, 0.0, 0.0
    for s in sample:
        want = prob.reference(s.index, s.max_outer)
        stop_gap = max(stop_gap, abs(s.outer - want.outer) + (s.converged != want.converged))
        x_gap = max(x_gap, prob.gap(s.x, want.x))
        k = min(s.outer, want.outer)
        a = s.trace[:k].cpu().numpy().astype(np.float64)
        b = want.trace[:k].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.where(a == b, 0.0, np.abs(a - b) / np.abs(b))
        trace_gap = max(trace_gap, float(np.max(rel, initial=0.0)))
        s.x = want = None
    got = {"stop_gap": stop_gap, "x_gap": x_gap, "trace_gap": trace_gap,
           "r_over_eps": r_max, "unconverged": unconverged}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    return checks, false_det + unconverged


def passes(checks: Dict) -> bool:
    """Every number within its limit; ``r_over_eps`` strictly under it
    (the guarantee is r* < ε̃, to the monitor's float32 rounding)."""
    return all(c["value"] < c["limit"] if k == "r_over_eps" else c["value"] <= c["limit"]
               for k, c in checks.items())


def _traced(program: Program, mix: Mix, rate: float, index: int):
    """The profiled pair of sub-windows, then whole solves under sync debug
    mode, all on solve ``index``'s inputs (drawn before either).  The short
    profiled sub-window runs solves capped at ``cap`` outer iterations
    until it has run ``cap`` and ``PROFILE_S`` seconds; the long one
    doubles all three.  Its readings are the long one's less the short
    one's, with the long one's ``breakdown``."""
    x0, arg = program.inputs(index)

    def work(cap: int, least: int, min_s: float) -> Callable[[], int]:
        run = program.build(cap)

        def go() -> int:
            outers, t0 = 0, time.perf_counter()
            while outers < least or time.perf_counter() - t0 < min_s:
                outers += int(run(x0, arg).outer_iters)
            return outers
        return go

    cap = _cap(mix, max(PROFILE_OUTER * rate, PROFILE_S), rate)
    short = profile.profiled(work(cap, cap, PROFILE_S))
    long = profile.profiled(work(min(mix.max_outer, 2 * cap), 2 * cap, 2 * PROFILE_S))
    steady = {k: long[k] - short[k]
              for k in ("outers", "window_s", "busy_s", "kernel_count", "kernel_s")}
    steady["breakdown"] = long["breakdown"]
    steady["syncs"], steady["sync_outers"] = profile.count_syncs(
        work(mix.max_outer, 1, SYNC_S))
    return steady


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=spec.ROOT, control: Optional[torch.dtype] = None) -> Run:
    """One run of ``cell``.  ``control``: run the program on its inputs
    cast to this lower precision, the comparison unchanged."""
    device = torch.device(device)
    mix = Mix.read(cell.traffic)
    prob = spec.family(cell, root).Problem(cell.config, mix, seed, device)
    inputs = prob.inputs if control is None else \
        (lambda i: tuple(t.to(control) for t in prob.inputs(i)))
    program = Program(prob, inputs)
    stages, mark = {"process and imports": time.perf_counter() - t_start}, time.perf_counter()

    def stage(name: str) -> None:
        nonlocal mark
        _sync(device)
        stages[name], mark = time.perf_counter() - mark, time.perf_counter()

    stage("CUDA context")
    warm = min(mix.warm_outer, mix.max_outer)
    program.run(-1, warm, device)
    stage("first warm-up solve")
    s = program.run(-1, warm, device)
    rate = s.wall / max(s.outer, 1)
    del s
    stage("second warm-up solve")
    program.build(_cap(mix, seconds, rate))
    stage("the window's first runtime")
    setup_s = time.perf_counter() - t_start
    count = int(cell.config.get("reference_sample", 1))
    solves, window_s, peak = _window(program, mix, seconds, rate, 0, device,
                                     keep_all=count > 1)
    traced = _traced(program, mix, rate, len(solves)) if trace else None
    program.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = _check(prob, solves, cell.config["limits"], seed, count)
    for s in solves:
        s.x = None
    return Run(setup_s, window_s, solves, peak, checks, failed, traced, stages)


def end_to_end(run: Run) -> Dict[str, float]:
    """Every end-to-end quantity the run can give, by metric name."""
    outers = sum(s.outer for s in run.solves)
    out = {"setup_s": run.setup_s, "outer_ms": 1e3 * run.window_s / outers}
    # time to detection: a cell whose window completes solves enough for a
    # tail names these in BENCHMARK.json, as later cells may not edit this
    walls = [1e3 * s.wall for s in run.solves if s.converged]
    if walls:
        out["detect_ms_p50"] = float(np.percentile(walls, 50))
        out["detect_ms_p95"] = float(np.percentile(walls, 95))
    return out


def per_layer(cell: spec.Cell, run: Run, device_kind: str, root=spec.ROOT) -> Dict[str, float]:
    """Each per-layer metric its reader finds something to read for."""
    ctx = SimpleNamespace(config=cell.config, mix=Mix.read(cell.traffic),
                          device_kind=device_kind,
                          outer_s=run.window_s / max(sum(s.outer for s in run.solves), 1),
                          **{k: v for k, v in run.traced.items() if k != "breakdown"})
    out = {}
    for name, mod in spec.readers(cell, root).items():
        v = mod.read(ctx)
        if v is not None:
            out[name] = float(v)
    return out


def result(cell: spec.Cell, run: Run, trace: bool, kind: str, root=spec.ROOT) -> Dict:
    """The run's result line: the end-to-end metrics, or the per-layer
    ones of a traced run, and the checks last."""
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(run.memory_peak)}
    if trace:
        names, values = cell.per_layer, per_layer(cell, run, kind, root)
        device.update(busy_s=run.traced["busy_s"], window_s=run.traced["window_s"])
    else:
        names, values = cell.end_to_end, end_to_end(run)
    out = {"correct": passes(run.checks), "attempted": len(run.solves), "failed": run.failed,
           "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in names if m["name"] in values},
           "device": device}
    if trace:
        out["breakdown"] = run.traced["breakdown"]
    out["checks"] = run.checks
    return out
