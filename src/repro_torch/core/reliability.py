"""Replay traces + the false/late-detection oracle (paper §4 reliability);
the port's copy of the JAX package's ``core/reliability.py``.

The paper's reliability metric compares the residual a protocol *detected*
against the exact residual of the assembled iterate — detection is
**false** when the protocol claims r < ε while the true state is far above
it, and merely **late** when the claim is sound but fires long after the
true residual first crossed ε.  A ``RunResult`` shows only ``r_star`` (the
exact residual at full stop); this module records enough during a run to
score both failure modes per run:

* ``TraceRecorder`` — an engine observer (``AsyncEngine(..., recorder=)``)
  that logs every sweep/send/drop/detect event with virtual timestamps,
  samples the exact residual trajectory every ``residual_stride`` sweeps,
  and captures ``r(x̄)`` at the detection instant.  The event log is a pure
  function of ``EngineConfig.seed`` (the engine, its block-buffered delay
  draws, and scenario effects all consume one RNG stream), so two runs with
  identical configs produce byte-identical traces — ``fingerprint()`` is
  the determinism check and the replay key.
* ``detection_report`` — the oracle: detected ε vs. true residual at
  detection time (false detection at ``factor×`` disagreement), plus
  detection latency overhead against the first trajectory crossing.
* ``platform_health`` — replays the sweep trace through the runtime's
  HeartbeatMonitor/StragglerPolicy (runtime/fault_tolerance.py), closing
  the loop between simulated scenarios and the production policies.

A note on *which* protocols may false-detect: PFAIT samples live local
residuals against stale dependency views, and NFAIS5 records last-delivered
dependencies — both trust the network to keep mixing interface data, so a
frozen/lossy platform can starve them into agreeing on a wrong answer.
NFAIS2 snapshot messages carry the interface data itself and
ExactSnapshotFIFO cuts are consistent by construction (given its reliable
FIFO precondition) — their detected residual is exact for the recorded
vector, so they can be late or undetected but never false *about that
record* (``BaseProtocol.claim == "recorded"``; the oracle recomputes the
record's residual independently).  The **live** state at the detection
instant is a different quantity for every protocol: under heavy-tailed
delays an ancient in-flight interface delivery can transiently spike
``r(x̄)`` at any stopping instant — reported as ``overshoot`` but only
scored as a false detection for the live-claim protocols.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


from repro_torch.core.async_engine import AsyncEngine, EngineConfig, Msg, RunResult
from repro_torch.runtime.fault_tolerance import PlatformHealth, health_from_sweeps


# ---------------------------------------------------------------------------
# Trace recording
# ---------------------------------------------------------------------------


class TraceRecorder:
    """Engine observer: event log + exact-residual trajectory samples.

    ``residual_stride``: sample ``problem.exact_residual`` every N-th sweep
    event (0 disables trajectory sampling; the detection-instant capture
    always happens).  Sampling is O(global grid) — affordable at lab scale,
    and it reads engine state without perturbing the RNG stream, so traces
    with and without sampling are event-identical.

    ``record_sends``: log per-message send/drop events (the full replay
    trace).  Campaign matrix runs pass False — the oracle and the platform
    health replay only consume sweep/detect events, and skipping the ~4
    send appends per sweep is a measurable slice of a cell.  Fingerprints
    of traces with different ``record_sends`` are incomparable.
    """

    def __init__(self, residual_stride: int = 0, record_sends: bool = True):
        self.residual_stride = int(residual_stride)
        self.record_sends = bool(record_sends)
        self.events: List[Tuple] = []
        self.residual_samples: List[Tuple[float, float]] = []
        self.detect: Optional[Tuple[float, float]] = None   # (t, detected ε)
        self.true_at_detect: Optional[float] = None          # r(x̄) at detect
        self.certified_at_detect: Optional[float] = None     # r(record) if any
        self.active_at_detect: Optional[float] = None        # r restricted to
        #                                     the active membership at detect
        self.membership: List[Tuple[float, str, int]] = []   # (t, kind, worker)
        self.claim: str = "live"                             # protocol claim
        self.result: Optional[RunResult] = None
        self._sweeps = 0

    # -- engine hooks -------------------------------------------------------
    def on_sweep(self, eng: AsyncEngine, t: float, i: int) -> None:
        self.events.append(("sweep", t, i, int(eng.k[i])))
        self._sweeps += 1
        if self.residual_stride and self._sweeps % self.residual_stride == 0:
            self.residual_samples.append(
                (t, float(eng.problem.exact_residual(eng.x))))

    def on_send(self, eng: AsyncEngine, msg: Msg, t: float,
                deliver: Optional[float]) -> None:
        # deliver=None marks a scenario-dropped message
        if self.record_sends:
            self.events.append(("send", t, msg.src, msg.dst, msg.kind,
                                deliver))

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        self.membership.append((t, kind, worker))
        self.events.append(("member", t, kind, worker))

    def on_detect(self, eng: AsyncEngine, t: float, detected: float) -> None:
        self.detect = (t, float(detected))
        self.true_at_detect = float(eng.problem.exact_residual(eng.x))
        self.claim = getattr(eng.protocol, "claim", "live")
        elastic = bool(getattr(eng, "membership_changes", 0)) or not all(
            getattr(eng, "active", [True]))
        if elastic:
            # ground truth under dynamic membership: the active subsystem's
            # residual (inactive blocks are frozen boundary data — Daggitt &
            # Griffin's dynamic-iteration fixed point), which is what any
            # claim made by the surviving membership is actually about
            self.active_at_detect = float(eng.exact_active_residual())
        rec = getattr(eng.protocol, "recorded_vector", lambda: None)()
        if rec is not None:
            if elastic:
                # holes in the record are inactive workers: substitute
                # their frozen live blocks and score the active subsystem
                # of the assembled vector
                assembled = [r if r is not None else eng.x[i]
                             for i, r in enumerate(rec)]
                self.certified_at_detect = float(
                    eng.exact_active_residual(xs=assembled))
            else:
                self.certified_at_detect = float(
                    eng.problem.exact_residual(rec))
        self.events.append(("detect", t, float(detected), self.true_at_detect,
                            self.certified_at_detect))

    def on_finish(self, eng: AsyncEngine, result: RunResult) -> None:
        self.result = result
        # claim is also captured here so UNDETECTED runs still report the
        # protocol's claim kind (on_detect never fired for them)
        self.claim = getattr(eng.protocol, "claim", "live")
        self.events.append(("finish", eng.now, result.terminated,
                            result.k_max, result.k_min))

    # -- trace identity -----------------------------------------------------
    def sweep_events(self) -> List[Tuple[float, int]]:
        return [(e[1], e[2]) for e in self.events if e[0] == "sweep"]

    def fingerprint(self) -> str:
        """Deterministic digest of the full event log (replay identity)."""
        h = hashlib.sha256()
        for e in self.events:
            h.update(repr(e).encode())
        return h.hexdigest()


# ---------------------------------------------------------------------------
# The oracle
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DetectionReport:
    """Per-run reliability verdict (paper §4's metric, per run)."""

    terminated: bool
    eps: float
    detected_residual: float      # the protocol's claim (inf if undetected)
    true_at_detect: float         # r(x̄) at the detection instant (inf if n/a)
    overshoot: float              # true_at_detect / eps (inf if undetected)
    false_detection: bool         # the protocol's *claim* was > factor·ε off
    factor: float                 # the disagreement factor used
    t_detect: float
    t_first_below: Optional[float]   # first trajectory sample with r ≤ ε
    latency_overhead: Optional[float]  # t_detect − t_first_below (late-ness)
    claim: str = "live"           # what was scored: live state or a record
    certified_residual: Optional[float] = None  # r(recorded vector) if any
    membership_changes: int = 0   # crash/join/restore events during the run
    active_residual: Optional[float] = None  # r of the active subsystem at
    #                               detect (None when membership never changed)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def detection_report(rec: TraceRecorder, eps: float,
                     factor: float = 10.0) -> DetectionReport:
    """Score one recorded run.

    ``factor`` separates *false* detection from the benign overshoot the
    paper's ε-margin already budgets for: a detection is false when the
    residual backing the protocol's claim exceeds ``factor·ε`` at the
    detection instant (a decade, matching the paper's decade-quantised
    margins) — i.e. no reasonable margin policy around ε would have
    absorbed the error.

    Which residual backs the claim depends on the protocol
    (``BaseProtocol.claim``): PFAIT and NFAIS5 assert the *live* state is
    converged, so they are scored against ``r(x̄)`` at the detection
    instant.  NFAIS2 and the Chandy–Lamport snapshot certify a *recorded
    consistent vector* (whose data they carry/pin) — they are scored
    against the independently recomputed residual of that record.  The live
    ``overshoot`` is still reported for every protocol: under heavy-tailed
    delays an ancient in-flight interface delivery can transiently spike
    the live residual at any stopping instant, for any protocol — that is
    a platform property, not a detection lie (the JAX package's EXPERIMENTS.md).
    """
    eps = float(eps)
    t_first = next((t for t, r in rec.residual_samples if r <= eps), None)
    n_member = len(rec.membership)
    if rec.detect is None:
        return DetectionReport(
            terminated=False, eps=eps,
            detected_residual=float("inf"), true_at_detect=float("inf"),
            overshoot=float("inf"), false_detection=False, factor=factor,
            t_detect=float("inf"), t_first_below=t_first,
            latency_overhead=None, claim=rec.claim,
            membership_changes=n_member,
        )
    t_detect, claimed = rec.detect
    true_r = float(rec.true_at_detect)
    certified = rec.certified_at_detect
    active_r = rec.active_at_detect
    if rec.claim == "recorded" and certified is not None:
        scored = float(certified)
    elif active_r is not None:
        # dynamic membership: a live claim is made by (and about) the
        # active subsystem — inactive blocks are boundary data, not part
        # of the converging system
        scored = float(active_r)
    else:
        scored = true_r
    return DetectionReport(
        terminated=True, eps=eps,
        detected_residual=claimed, true_at_detect=true_r,
        overshoot=true_r / eps,
        false_detection=(claimed < eps and scored > factor * eps),
        factor=factor,
        t_detect=t_detect, t_first_below=t_first,
        latency_overhead=(t_detect - t_first) if t_first is not None else None,
        claim=rec.claim,
        certified_residual=(float(certified) if certified is not None
                            else None),
        membership_changes=n_member,
        active_residual=(float(active_r) if active_r is not None else None),
    )


def nfais5_slack(p: int, m: int) -> float:
    """The (1 + c(p, m)) slack of NFAIS5's approximate-snapshot guarantee
    ([12], protocol 5): records lag true interfaces by at most m sweeps of
    sub-ε drift per worker, so the detected residual undershoots the true
    snapshot residual by at most ~p/m worker-contributions of size ε.
    Conservative calibration for this implementation's lab scales."""
    return 1.0 + p / max(float(m), 1.0)


# ---------------------------------------------------------------------------
# Traced runs / replay
# ---------------------------------------------------------------------------


def run_traced(
    make_problem: Callable[[], "object"],
    cfg: EngineConfig,
    make_protocol: Callable[["object"], "object"],
    residual_stride: int = 0,
    record_sends: bool = True,
) -> Tuple[RunResult, TraceRecorder]:
    """One fully-recorded engine run.  Factories (not instances) so the
    caller can re-invoke for an exact replay: same cfg.seed ⇒ identical
    trace fingerprint."""
    problem = make_problem()
    rec = TraceRecorder(residual_stride=residual_stride,
                        record_sends=record_sends)
    eng = AsyncEngine(problem, cfg, make_protocol(problem), recorder=rec)
    return eng.run(), rec


def replay_matches(
    make_problem: Callable[[], "object"],
    cfg: EngineConfig,
    make_protocol: Callable[["object"], "object"],
    residual_stride: int = 0,
) -> bool:
    """Run twice from the same seed and compare trace fingerprints — the
    determinism invariant every oracle verdict rests on."""
    _, a = run_traced(make_problem, cfg, make_protocol, residual_stride)
    _, b = run_traced(make_problem, cfg, make_protocol, residual_stride)
    return a.fingerprint() == b.fingerprint()


def platform_health(rec: TraceRecorder, p: int,
                    compute_base: float) -> PlatformHealth:
    """Diagnose the platform from the sweep trace via the runtime's
    fault-tolerance policies (heartbeat timeout = 20 sweep periods)."""
    return health_from_sweeps(rec.sweep_events(), p,
                              timeout=20.0 * compute_base)
