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
``seconds`` on its clock.  ``memory_peak_bytes`` is the program's: each
solve's peak less the states of earlier solves that the harness holds for
the check.  A traced run's window also records the program's spans and
counters (``spans.recording()``) for the per-layer readers:
``span_totals`` (``Recorder.totals()``) and ``counts`` (``host_syncs``,
``ghost_bytes``).

The check compares with the plain reference on the same inputs:

* every detection's exact residual must be under ε̃, the guarantee, to
  the rounding of the monitor's float32 values (the limit of
  ``r_over_eps``).  It is read right after the detection's solve, once
  that solve's peak is read, with the window's clock stopped, and the
  state is then let go: a window of many solves need not hold every
  state on the card until it closes;
* after the window (``memory_peak_bytes`` read first, the program's state
  freed), a sample of the solves (drawn from the seed, the longest always
  in it) is solved again by the plain reference: the outer iteration it
  stops at and whether it converged, its state and the monitor's series.

A configuration that names a ``backend`` runs as a world of ranks, one a
card (``world.py``): this process is rank 0, which alone times, traces
and checks; the program's state it checks is the one ``_result`` gathered
to it.  ``memory_peak_bytes`` is then the fullest rank's."""
from __future__ import annotations

import contextlib
import functools
import math
import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import profile, spec, world as wd
from perfbench.traffic import Mix

#: the profiled sub-window runs solves capped at twice this many outer
#: iterations, or twice the iterations of this many seconds where that is
#: more, until it has run that cap and twice these seconds
PROFILE_OUTER, PROFILE_S = 4, 0.5
#: the sub-window under sync debug mode, with the kernels' work sink open:
#: whole solves, as the window runs them, for at least this many seconds
SYNC_S = 1.0
#: the profiled readings of a world that are the means over its ranks
RANK_MEANS = ("window_s", "busy_s", "kernel_count", "kernel_s")


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
    #: a detection's exact residual over ε̃, read right after its solve
    r_over_eps: Optional[float] = None


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
    #: the forbidden modules (``world.FORBIDDEN``) a follower rank loaded
    forbidden: List[str] = field(default_factory=list)
    #: the program's peak bytes on each rank, rank 0 first (``memory_peak``
    #: is the largest)
    memory_peaks: List[int] = field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program's runtime for a cell, one build for each ``max_outer``
    it is asked for (the mix's, the warm-up's, a cap).  On a ``world``,
    every follower rank builds, draws and calls as this rank does."""

    def __init__(self, prob, inputs: Callable, world: Optional[wd.World] = None):
        self.prob, self.inputs, self.world = prob, inputs, world
        self._built: Dict[int, Callable] = {}

    def _ask(self, cmd: str, arg=None) -> None:
        if self.world is not None:
            self.world.send(cmd, arg)

    def _answers(self) -> None:
        if self.world is not None:
            self.world.answers()

    @property
    def follower_peaks(self) -> List[int]:
        """Each follower's peak bytes in the last call, in rank order."""
        return self.world.peaks if self.world is not None else []

    def profiled(self, work: Callable[[], int]) -> Dict:
        """``profile.profiled(work)``, every rank traced alike, each over
        its own outer spans.  In a world each rank's readings are kept
        (``ranks``, rank 0 first), every rank's outer spans must number
        rank 0's, and the window, the busy time, and the kernel count and
        time are the ranks' means (the ``breakdown`` is this rank's)."""
        self._ask("trace")
        self._answers()
        out = profile.profiled(work)
        if self.world is not None:
            self.world.send("untrace")
            ranks = [out] + self.world.answers()
            for r, got in enumerate(ranks):
                if got["outers"] not in (None, out["outers"]):
                    raise RuntimeError(f"rank {r}'s trace holds {got['outers']} outer spans "
                                       f"where rank 0 ran {out['outers']} outer iterations")
            out["ranks"] = [{k: got[k] for k in ("outers", *RANK_MEANS)} for got in ranks]
            out.update({k: sum(got[k] for got in ranks) / len(ranks) for k in RANK_MEANS})
        return out

    def draw(self, index: int) -> tuple:
        """Solve ``index``'s inputs, on every rank's card once this returns."""
        self._ask("inputs", index)
        x = self.inputs(index)
        self._answers()
        return x

    def build(self, max_outer: int) -> Callable:
        if max_outer not in self._built:
            self._ask("build", max_outer)
            run = self.prob.runtime(max_outer)
            self._answers()
            if self.world is not None:
                run = functools.partial(self.world.call, run, max_outer)
            self._built[max_outer] = run
        return self._built[max_outer]

    def run(self, index: int, max_outer: int, device: torch.device) -> Solve:
        """Solve ``index``: its inputs drawn, then the timed call."""
        x0, arg = self.draw(index)
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
        self._ask("free")
        self._answers()


def _cap(mix: Mix, seconds: float, rate: float) -> int:
    """A solve's ``max_outer`` with ``seconds`` of the window left."""
    return min(mix.max_outer, max(1, math.ceil(seconds / rate)))


def _window(program: Program, mix: Mix, seconds: float, rate: float, first: int,
            device: torch.device, keep_all: bool, certify: Callable[[Solve], float]):
    """The closed loop: solves ``first``, ``first + 1``, … until the first
    return after ``seconds`` on the window's clock; (solves, the clock's
    seconds, the program's peak bytes on each rank).  Each detection's
    ``r_over_eps`` is ``certify(solve)``, read with the clock stopped.  A
    solve's state is then kept for the check only where ``keep_all``, or
    where it is the longest so far (the one sample that is always drawn)."""
    cuda = device.type == "cuda"
    solves: List[Solve] = []
    longest: Optional[Solve] = None
    peaks: List[int] = []   # this rank's, then each follower's
    stopped = 0.0           # seconds the clock stood while detections were certified
    t0 = time.perf_counter()
    now = t0
    while now - stopped < t0 + seconds:
        if cuda:
            held = sum(t.x.numel() * t.x.element_size() for t in solves if t.x is not None)
            torch.cuda.reset_peak_memory_stats(device)
        s = program.run(first + len(solves), _cap(mix, t0 + seconds - now + stopped, rate),
                        device)
        got = [torch.cuda.max_memory_allocated(device) - held if cuda else 0,
               *program.follower_peaks]
        peaks = [max(a, b) for a, b in zip(got, peaks or got)]
        if s.converged:
            mark = time.perf_counter()
            s.r_over_eps = certify(s)
            stopped += time.perf_counter() - mark
        if longest is None or s.outer > longest.outer:
            if longest is not None and not keep_all:
                longest.x = None
            longest = s
        elif not keep_all:
            s.x = None
        solves.append(s)
        now = time.perf_counter()
    return solves, now - t0 - stopped, peaks


def _sample(solves: List[Solve], count: int, seed: int) -> List[Solve]:
    """``count`` solves drawn from ``seed``, the one of most outer
    iterations always among them."""
    longest = max(solves, key=lambda s: s.outer)
    rest = [s for s in solves if s is not longest]
    rng = random.Random(seed)
    return [longest] + rng.sample(rest, min(len(rest), max(count - 1, 0)))


def _check(prob, solves: List[Solve], limits: Dict, seed: int, count: int) -> tuple:
    """Compare with the plain reference; (checks, failed)."""
    r = [s.r_over_eps for s in solves if s.converged]
    r_max = max(r, default=0.0)
    false_det = sum(not v < limits["r_over_eps"] for v in r)
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
    """A profiled session whose readings are dropped, which takes the
    profiler's first start-up, then the profiled sub-window, then whole
    solves under sync debug mode, all on solve ``index``'s inputs (drawn
    before any).  The sub-window's cap is twice ``PROFILE_OUTER``
    iterations or twice those of ``PROFILE_S`` seconds at ``rate``,
    whichever is more; it runs solves capped there until it has run that
    many and ``2 * PROFILE_S`` seconds.  Its readings are those of the
    outer iterations in it (``profile.read_trace``).  In the sync sub-window,
    which no profiler reads, the kernels also report their work to a sink
    (rank 0's): ``kernel_flops`` and ``kernel_bytes``."""
    from repro_torch.kernels import _build

    x0, arg = program.draw(index)

    def work(cap: int, least: int, min_s: float) -> Callable[[], int]:
        run = program.build(cap)

        def go() -> int:
            outers, t0 = 0, time.perf_counter()
            while outers < least or time.perf_counter() - t0 < min_s:
                outers += int(run(x0, arg).outer_iters)
            return outers
        return go

    program.profiled(work(1, 1, 0.0))
    cap = 2 * _cap(mix, max(PROFILE_OUTER * rate, PROFILE_S), rate)
    steady = program.profiled(work(min(mix.max_outer, cap), cap, 2 * PROFILE_S))
    sink = [0.0, 0.0]
    _build.WORK_SINKS.append(sink)
    try:
        steady["syncs"], steady["sync_outers"] = profile.count_syncs(
            work(mix.max_outer, 1, SYNC_S))
    finally:
        _build.WORK_SINKS.remove(sink)
    steady.update(kernel_flops=sink[0], kernel_bytes=sink[1])
    return steady


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=spec.ROOT, control: Optional[torch.dtype] = None,
             plant: Optional[Callable] = None) -> Run:
    """One run of ``cell`` on ``device``, or on a world of ``cell.chips``
    ranks where its configuration names a ``backend`` (``device`` then
    gives the type: rank r runs on ``cuda:r``, or on the CPU).
    ``control``: run the program on its inputs cast to this lower
    precision, the comparison unchanged.  ``plant``: a picklable function
    that every rank calls with ``patch(obj, name, value)`` before set-up
    (``world.planted``), to plant a fault underneath the program; this
    process undoes its patches at the end."""
    device = torch.device(device)
    k = wd.ranks(cell)
    world = None
    with wd.planted(plant):
        try:
            stages = {"process and imports": time.perf_counter() - t_start}
            job = wd.Job(cell, Path(root), seed, control, plant, device.type,
                         torch.get_num_threads())
            if k:
                mark = time.perf_counter()
                world = wd.World(job)
                device = job.device(0)
                stages["the world's ranks"] = time.perf_counter() - mark
            prob, inputs = job.problem(device, world.group if world else None)
            run = _run(cell, prob, Program(prob, inputs, world), seed, seconds, trace,
                       device, t_start, stages)
            if world is not None:
                run.forbidden = world.close()
            return run
        finally:
            if world is not None:
                world.kill()


def _run(cell: spec.Cell, prob, program: Program, seed: int, seconds: float, trace: bool,
         device: torch.device, t_start: float, stages: Dict[str, float]) -> Run:
    """Set-up, the window, the traced sub-windows, and the check."""
    mix = Mix.read(cell.traffic)
    mark = time.perf_counter()

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
    # a traced run's window also records the program's spans and counters
    # (rank 0's), with nothing else watching: a flag check and a clock read
    # a phase
    from repro_torch.core import spans
    with spans.recording() if trace else contextlib.nullcontext() as rec:
        solves, window_s, peaks = _window(
            program, mix, seconds, rate, 0, device, keep_all=count > 1,
            certify=lambda s: prob.exact_residual(s.index, s.x) / prob.eps_tilde)
    traced = None
    if trace:
        traced = _traced(program, mix, rate, len(solves))
        traced.update(span_totals=rec.totals(), counts=dict(rec.counts))
    program.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = _check(prob, solves, cell.config["limits"], seed, count)
    for s in solves:
        s.x = None
    return Run(setup_s, window_s, solves, max(peaks), checks, failed, traced, stages,
               memory_peaks=peaks)


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
