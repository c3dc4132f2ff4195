"""Composable adversarial platform scenarios for the async engine (the
port's copy of the JAX package's ``core/scenarios.py``; pure Python).

The paper's reliability claim (a protocol-free reduction yields a usable
global residual) is platform-dependent: Zou & Magoulès (arXiv:1907.01201)
show detection quality degrades with network regime.  This module turns the
engine's two hand-picked presets (``stable_platform`` / ``unstable_platform``)
into a *scenario algebra*: small frozen effect objects that transform the
engine's sampled delays, drop or spike individual messages, slow workers
persistently, or pause them mid-run — composed into a ``Scenario`` attached
to ``EngineConfig.scenario``.

Effects see every draw the engine makes and may consume additional draws
from the engine's single RNG stream, so a run is a pure function of
``EngineConfig.seed`` — the property the replay trace / false-detection
oracle in ``core.reliability`` relies on.

Hook contract (all optional, defaults are identity):

* ``channel(t, kind, delay, rng)`` → transformed delay, or ``None`` to drop
  the message (collective/reduction draws use ``kind="reduce"`` and are
  never dropped — a tree reduction is modelled as lossless-but-slow);
* ``compute(t, worker, delay, rng)`` → transformed sweep duration;
* ``paused_until(t, worker)`` → resume time if the worker is paused at
  ``t``, else ``None``.

``standard_scenarios()`` is the matrix the reliability lab sweeps:
the JAX package's benchmarks/reliability_matrix.py runs {PFAIT, NFAIS2, NFAIS5,
ExactSnapshotFIFO} × {convdiff, pagerank} × these scenarios and scores
each cell with the oracle.  Scenarios containing a lossy effect violate the
Chandy–Lamport precondition (reliable channels), so ``ExactSnapshotFIFO``
cells are reported as ``precondition_violated`` instead of run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Effect algebra
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Effect:
    """Identity platform effect; subclasses override the hooks they shape."""

    #: effects that may lose messages set this True (CL precondition check)
    lossy = False

    def channel(self, t: float, kind: str, delay: float,
                rng: np.random.Generator) -> Optional[float]:
        return delay

    def compute(self, t: float, worker: int, delay: float,
                rng: np.random.Generator) -> float:
        return delay

    def paused_until(self, t: float, worker: int) -> Optional[float]:
        return None

    # -- dynamic membership (static timelines, declared at construction) ---
    def membership_events(self) -> Tuple[Tuple[float, str, int], ...]:
        """``(t, kind, worker)`` membership transitions this effect injects
        (kind ∈ {"crash", "join", "restore"}).  Static by design: the engine
        schedules them as ordinary heap events at construction, so they
        consume no RNG draws and a run stays a pure function of the seed."""
        return ()

    def initially_inactive(self) -> Tuple[int, ...]:
        """Workers that start outside the membership (late joiners)."""
        return ()

    #: CheckpointRestart overrides this (as a real field) with its snapshot
    #: cadence; a plain class attribute here so asdict()/describe() of the
    #: existing effects is unchanged
    checkpoint_every = None


@dataclass(frozen=True)
class TailSpike(Effect):
    """Occasional huge per-message latency (non-FIFO channels reorder)."""

    prob: float = 0.1
    mult: float = 10.0
    kinds: Optional[Tuple[str, ...]] = None  # None = every message kind

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"TailSpike.prob={self.prob} not in [0, 1]")
        if self.mult < 1.0:
            raise ValueError(f"TailSpike.mult={self.mult} must be >= 1")

    def channel(self, t, kind, delay, rng):
        if self.kinds is not None and kind not in self.kinds:
            return delay
        return delay * self.mult if rng.random() < self.prob else delay


@dataclass(frozen=True)
class JitterBurst(Effect):
    """Correlated jitter: periodic windows where *every* channel (including
    reduction hops' staggered sampling) slows by ``mult`` simultaneously —
    the cross-channel correlation a per-message lognormal cannot produce."""

    period: float = 0.04
    duration: float = 0.01
    mult: float = 25.0
    phase: float = 0.0

    def __post_init__(self):
        if self.period <= 0.0:
            raise ValueError(f"JitterBurst.period={self.period} must be > 0")
        if not 0.0 < self.duration <= self.period:
            raise ValueError(
                f"JitterBurst.duration={self.duration} not in (0, period]")
        if self.mult < 1.0:
            raise ValueError(f"JitterBurst.mult={self.mult} must be >= 1")

    def channel(self, t, kind, delay, rng):
        if ((t - self.phase) % self.period) < self.duration:
            return delay * self.mult
        return delay


@dataclass(frozen=True)
class DropMessages(Effect):
    """Lossy channels: drop matching messages with probability ``prob``
    from time ``after`` on.  ``prob=1.0, after=t0`` is the *interface
    blackout* — dependency views freeze, every worker converges to its own
    frozen-BC subproblem, and protocols that trust live local residuals
    (PFAIT, NFAIS5) false-detect while data-carrying snapshots (NFAIS2)
    merely never fire."""

    prob: float = 0.2
    kinds: Tuple[str, ...] = ("data",)
    after: float = 0.0

    lossy = True

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"DropMessages.prob={self.prob} not in [0, 1]")
        if self.after < 0.0:
            raise ValueError(f"DropMessages.after={self.after} must be >= 0")

    def channel(self, t, kind, delay, rng):
        if kind in self.kinds and t >= self.after and rng.random() < self.prob:
            return None
        return delay


@dataclass(frozen=True)
class Straggler(Effect):
    """Persistently slow workers (the fault_tolerance.StragglerPolicy
    target): every sweep of the listed workers takes ``factor×`` longer."""

    workers: Tuple[int, ...] = (0,)
    factor: float = 8.0

    def __post_init__(self):
        if self.factor < 1.0:
            raise ValueError(f"Straggler.factor={self.factor} must be >= 1")

    def compute(self, t, worker, delay, rng):
        return delay * self.factor if worker in self.workers else delay


@dataclass(frozen=True)
class Pause(Effect):
    """Mid-run worker pause/resume: the worker performs no sweeps during
    [at, at+duration) (its in-flight messages still deliver).  The
    HeartbeatMonitor wiring in ``core.reliability`` detects the silence."""

    worker: int = 0
    at: float = 0.02
    duration: float = 0.05

    def __post_init__(self):
        if self.at < 0.0:
            raise ValueError(f"Pause.at={self.at} must be >= 0")
        if self.duration <= 0.0:
            raise ValueError(f"Pause.duration={self.duration} must be > 0")

    def paused_until(self, t, worker):
        if worker == self.worker and self.at <= t < self.at + self.duration:
            return self.at + self.duration
        return None


# ---------------------------------------------------------------------------
# Dynamic membership primitives (crash / join / checkpoint-restart)
# ---------------------------------------------------------------------------
#
# Unlike Pause, these change the *participant set* itself (Daggitt &
# Griffin's dynamic asynchronous iterations): a crashed worker performs no
# further sweeps, sends nothing, loses every message addressed to it, and is
# excluded from reductions and snapshot quorums; a joiner starts outside the
# membership (its block frozen at x^0) and is admitted mid-run; a
# checkpoint-restart crashes a worker and later re-admits it from the
# engine's periodic state snapshots — the event-level twin of the device
# runtime's crash → heartbeat-detect → restore → resume loop.


@dataclass(frozen=True)
class WorkerCrash(Effect):
    """Worker ``worker`` fail-stops at ``at`` and never returns."""

    worker: int = 0
    at: float = 0.05

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"WorkerCrash.worker={self.worker} must be >= 0")
        if self.at < 0.0:
            raise ValueError(f"WorkerCrash.at={self.at} must be >= 0")

    def membership_events(self):
        return ((self.at, "crash", self.worker),)


@dataclass(frozen=True)
class WorkerJoin(Effect):
    """Worker ``worker`` starts *outside* the membership and is admitted at
    ``at`` (elastic scale-up).  Its block stays frozen at the initial state
    until then — neighbours keep iterating against the x^0 interface they
    were seeded with, exactly as if the joiner's slot were a cold replica."""

    worker: int = 0
    at: float = 0.05

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"WorkerJoin.worker={self.worker} must be >= 0")
        if self.at < 0.0:
            raise ValueError(f"WorkerJoin.at={self.at} must be >= 0")

    def membership_events(self):
        return ((self.at, "join", self.worker),)

    def initially_inactive(self):
        return (self.worker,)


@dataclass(frozen=True)
class CheckpointRestart(Effect):
    """Worker ``worker`` crashes at ``at`` and is re-admitted after
    ``downtime`` from the most recent periodic state snapshot (the engine
    checkpoints every ``checkpoint_every`` of virtual time while any restart
    effect is attached).  Progress since that snapshot is rolled back — the
    recovery-cost regime the device runtime pays in real iterations."""

    worker: int = 0
    at: float = 0.05
    downtime: float = 0.05
    checkpoint_every: float = 0.02

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(
                f"CheckpointRestart.worker={self.worker} must be >= 0")
        if self.at < 0.0:
            raise ValueError(f"CheckpointRestart.at={self.at} must be >= 0")
        if self.downtime <= 0.0:
            raise ValueError(
                f"CheckpointRestart.downtime={self.downtime} must be > 0")
        if self.checkpoint_every <= 0.0:
            raise ValueError(
                f"CheckpointRestart.checkpoint_every="
                f"{self.checkpoint_every} must be > 0")

    def membership_events(self):
        return ((self.at, "crash", self.worker),
                (self.at + self.downtime, "restore", self.worker))


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """An ordered composition of effects (applied left to right).

    Effects that leave a hook at the ``Effect`` identity are pruned from
    that hook's dispatch list at construction (identity hooks draw nothing
    from the RNG, so pruning cannot change a run) — the engine consults
    ``channel_effects`` / ``compute_effects`` / ``pause_effects`` to skip
    per-event scenario calls entirely on hooks no effect shapes.
    """

    name: str = "baseline"
    effects: Tuple[Effect, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "channel_effects", tuple(
            e for e in self.effects if type(e).channel is not Effect.channel))
        object.__setattr__(self, "compute_effects", tuple(
            e for e in self.effects if type(e).compute is not Effect.compute))
        object.__setattr__(self, "pause_effects", tuple(
            e for e in self.effects
            if type(e).paused_until is not Effect.paused_until))
        object.__setattr__(self, "membership_effects", tuple(
            e for e in self.effects
            if type(e).membership_events is not Effect.membership_events))

    @property
    def lossy(self) -> bool:
        return any(e.lossy for e in self.effects)

    @property
    def elastic(self) -> bool:
        """True when any effect changes the participant set mid-run."""
        return bool(self.membership_effects)

    def membership_events(self) -> Tuple[Tuple[float, str, int], ...]:
        """Time-sorted ``(t, kind, worker)`` transitions over all effects."""
        out = []
        for e in self.membership_effects:
            out.extend(e.membership_events())
        return tuple(sorted(out))

    def initially_inactive(self) -> Tuple[int, ...]:
        out = set()
        for e in self.membership_effects:
            out.update(e.initially_inactive())
        return tuple(sorted(out))

    @property
    def checkpoint_every(self) -> Optional[float]:
        """Tightest snapshot cadence any restart effect requires (None when
        no effect restores from checkpoints)."""
        cadences = [e.checkpoint_every for e in self.membership_effects
                    if e.checkpoint_every is not None]
        return min(cadences) if cadences else None

    def channel_delay(self, t: float, kind: str, delay: float,
                      rng: np.random.Generator) -> Optional[float]:
        for e in self.channel_effects:
            delay = e.channel(t, kind, delay, rng)
            if delay is None:
                return None
        return delay

    def compute_delay(self, t: float, worker: int, delay: float,
                      rng: np.random.Generator) -> float:
        for e in self.compute_effects:
            delay = e.compute(t, worker, delay, rng)
        return delay

    def paused_until(self, t: float, worker: int) -> Optional[float]:
        resume = None
        for e in self.pause_effects:
            r = e.paused_until(t, worker)
            if r is not None:
                resume = r if resume is None else max(resume, r)
        return resume

    def describe(self) -> Dict:
        return {
            "name": self.name,
            "lossy": self.lossy,
            "effects": [
                {"kind": type(e).__name__, **dataclasses.asdict(e)}
                for e in self.effects
            ],
        }


# ---------------------------------------------------------------------------
# The reliability-lab scenario matrix
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenarioSpec:
    """A scenario plus the platform preset it runs on (``platform`` is a
    key into ``core.async_engine`` preset factories: stable | unstable |
    heavy_tail)."""

    name: str
    platform: str
    scenario: Scenario

    @property
    def lossy(self) -> bool:
        return self.scenario.lossy


def standard_scenarios(base: float = 1e-3) -> Dict[str, ScenarioSpec]:
    """The ~8-regime sweep of the reliability matrix.  ``base`` is the
    platform compute_base; every time constant scales with it so the
    scenarios stress the same *relative* regimes at any simulation scale."""

    def spec(name, platform, *effects):
        return ScenarioSpec(name, platform, Scenario(name, tuple(effects)))

    return {
        # the paper's own two regimes, as baselines for the oracle
        "stable": spec("stable", "stable"),
        "unstable": spec("unstable", "unstable"),
        # heavy-tailed channel latency (Pareto tail index 1.2: occasional
        # delays orders of magnitude above the median)
        "heavy_tail": spec("heavy_tail", "heavy_tail"),
        # correlated jitter bursts: all channels ×30 for a quarter of
        # every 40-sweep window
        "burst": spec("burst", "stable",
                      JitterBurst(period=40 * base, duration=10 * base,
                                  mult=30.0)),
        # lossy + reordering channels (CL precondition violated)
        "drop_reorder": spec("drop_reorder", "stable",
                             DropMessages(prob=0.25, kinds=("data",)),
                             TailSpike(prob=0.15, mult=12.0,
                                       kinds=("data",))),
        # one worker persistently 10× slower
        "straggler": spec("straggler", "stable",
                          Straggler(workers=(0,), factor=10.0)),
        # mid-run pause/resume of one worker
        "pause_resume": spec("pause_resume", "stable",
                             Pause(worker=1, at=50 * base,
                                   duration=200 * base)),
        # interface blackout: data messages stop entirely after 30 sweeps'
        # worth of time — the constructed PFAIT false-detection regime
        "blackout": spec("blackout", "stable",
                         DropMessages(prob=1.0, kinds=("data",),
                                      after=30 * base)),
    }


def elastic_scenarios(base: float = 1e-3) -> Dict[str, ScenarioSpec]:
    """The dynamic-membership sweep (the JAX package's
    benchmarks/bench_elastic.py): crash,
    join, checkpoint-restart and their compositions, all on the stable
    platform so any detection failure is attributable to the membership
    change itself.  Worker indices assume p >= 4 (the lab's standard
    decomposition)."""

    def spec(name, platform, *effects):
        return ScenarioSpec(name, platform, Scenario(name, tuple(effects)))

    # Timings are calibrated against the detection times of the benchmark
    # lane (convdiff n=12 p=4 rho=0.9, eps=1e-6 at the problem's max-norm):
    # with no faults every protocol detects at t ≈ (92–122)·base, so every
    # event below lands at t < 90·base — each scenario's full membership
    # sequence is guaranteed to be *in effect before any detection fires*,
    # which is what makes the matrix a test of the protocols' bookkeeping
    # rather than of event/detection racing.
    return {
        # fail-stop early (before any protocol has converged once)
        "crash_early": spec("crash_early", "stable",
                            WorkerCrash(worker=2, at=30 * base)),
        # fail-stop late (snapshot rounds already in flight, detection near)
        "crash_late": spec("crash_late", "stable",
                           WorkerCrash(worker=1, at=80 * base)),
        # two staggered crashes: membership shrinks twice (4 → 3 → 2)
        "crash_two": spec("crash_two", "stable",
                          WorkerCrash(worker=2, at=40 * base),
                          WorkerCrash(worker=0, at=80 * base)),
        # elastic scale-up: worker 3's block stays frozen at x^0 until
        # admission — survivors converge toward the wrong (frozen-BC) fixed
        # point first, then must re-converge with the joiner
        "join_late": spec("join_late", "stable",
                          WorkerJoin(worker=3, at=60 * base)),
        # crash + checkpoint-restart: progress since the last periodic
        # snapshot is rolled back on re-admission.  Downtime is short
        # enough that the restore lands *before* the survivors' detection
        # fires — the protocols must carry their bookkeeping through the
        # full crash → restore → re-converge cycle
        "crash_restart": spec("crash_restart", "stable",
                              CheckpointRestart(worker=1, at=40 * base,
                                                downtime=40 * base,
                                                checkpoint_every=20 * base)),
        # churn: a join and an independent checkpoint-restart overlap
        "churn": spec("churn", "stable",
                      WorkerJoin(worker=3, at=40 * base),
                      CheckpointRestart(worker=1, at=60 * base,
                                        downtime=40 * base,
                                        checkpoint_every=20 * base)),
    }


def scenario_registry(base: float = 1e-3) -> Dict[str, ScenarioSpec]:
    """Merged lookup: the reliability matrix's standard regimes plus the
    elastic membership sweep (names are disjoint by construction)."""
    out = standard_scenarios(base)
    out.update(elastic_scenarios(base))
    return out
