"""Event-driven asynchronous-iterations engine (paper model (2), §2.1).

``p`` simulated processes free-run local relaxation sweeps at
heterogeneous speeds, exchange interface data over FIFO or non-FIFO
channels with random delays, and a pluggable detection protocol
(``core/protocols.py``) decides termination: the execution model of the
paper's MPI experiments, with the platform replaced by controllable delay
distributions and virtual time.

This is the port's copy of the JAX package's engine (``core/async_engine.py``).
The event loop is host Python (``heapq``), draw for draw the JAX engine's: one
``np.random.Generator`` seeded from ``EngineConfig.seed`` feeds the
block-buffered delay draws and every scenario effect, so equal seeds give
equal runs in both packages.  The numerical work of a sweep is the
problem's: the port's problems (``solvers/convdiff.py``, ``pagerank.py``,
``mlfixed.py``) keep their blocks as tensors on their device and run every
sweep through the CUDA kernels there.  A message's bytes are its payload
tensor's ``nbytes``; checkpoints and protocol records ``clone()`` a block,
never keep a view.

**Fused hot path** (``EngineConfig.fused``, default on): when the problem
implements ``update_with_residual(i, x_i, deps) -> (x_new, r_i)`` the
engine prefers it over the ``update`` + ``local_residual`` pair.  ``r_i``
is then the residual of the *pre-sweep* state, one sweep staler than the
unfused post-update evaluation.  The engine asks the protocol
(``wants_residual`` hook, default True) whether it will consume ``r_i``
this iteration and skips the residual when not (PFAIT never does: it
samples live state during reductions); protocols then receive
``r_i = NaN``.  On the card each residual read is one device→host sync.

**Reliability lab hooks**: ``EngineConfig.scenario`` attaches a
composable adversarial-platform scenario (``core/scenarios.py``);
``AsyncEngine(..., recorder=)`` attaches an observer
(``core/reliability.py:TraceRecorder``, ``core/trace.py:EngineTraceObserver``)
of sweeps, sends/drops, membership changes and the detection instant.

Measured outputs per run (the paper's reported quantities):
  * ``r_star``  — final exact residual r(x̄) at the instant every process
                  has stopped (Tables 1, 3, 4),
  * ``wtime``   — virtual wall-clock time at full stop (Tables 2, 5),
  * ``k_max``   — max local iteration count over processes (Tables 2, 5),
  * message/byte accounting per message kind (protocol overhead analysis).
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol as TProtocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.residual import combine_contributions


# ---------------------------------------------------------------------------
# Problem interface
# ---------------------------------------------------------------------------


class DecomposedProblem(TProtocol):
    """A fixed-point problem x = f(x) decomposed over p workers; blocks are
    tensors on the problem's device."""

    p: int
    ord: float  # residual norm order (1.0, 2.0 or inf)

    def neighbors(self, i: int) -> Sequence[int]: ...

    def init_local(self, i: int) -> torch.Tensor: ...

    def update(self, i: int, x_i: torch.Tensor,
               deps: Dict[int, torch.Tensor]) -> torch.Tensor:
        """One local relaxation sweep using the current dependency view."""
        ...

    def interface(self, i: int, x_i: torch.Tensor, j: int) -> torch.Tensor:
        """The interface data neighbour j needs from i (a fresh tensor)."""
        ...

    def local_residual(self, i: int, x_i: torch.Tensor,
                       deps: Dict[int, torch.Tensor]) -> float:
        """r_i — this worker's pre-σ residual contribution w.r.t. its view."""
        ...

    def exact_residual(self, xs: Sequence[torch.Tensor]) -> float:
        """r(x̄) for the assembled global vector (ground truth)."""
        ...

    # Optional extension (fused hot path — see module docstring): one sweep
    # with the pre-sweep residual as a by-product.  Must satisfy
    #   update_with_residual(i, x, deps)
    #     == (update(i, x, deps), local_residual(i, x, deps))
    # with r_i None when need_residual=False.  The engine feature-detects it.
    #
    # def update_with_residual(self, i, x_i, deps, need_residual=True):
    #     ...


# ---------------------------------------------------------------------------
# Delay models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DelayModel:
    """Random delay with scale ``base`` and a jitter floor.

    ``dist`` picks the family:
      * ``lognormal`` — median ``base``, dispersion ``sigma``.  Stable
        single-site platforms (the paper's SGI ICE X) have small sigma;
        unstable/multi-site ones have large sigma.
      * ``pareto``    — ``base·(1 + Pareto(shape))``: heavy tail with index
        ``shape`` (≤ 2 ⇒ infinite variance — grid/WAN-like spikes).
      * ``fixed``     — deterministic ``base`` (hand-built oracle traces).

    Parameters are validated here, at construction: a bad sigma/shape used
    to surface only mid-run as a numpy error deep inside
    ``AsyncEngine.run``.
    """

    base: float
    sigma: float = 0.25
    floor: float = 1e-6
    dist: str = "lognormal"
    shape: float = 1.5  # pareto tail index (dist="pareto" only)

    _DISTS = ("lognormal", "pareto", "fixed")

    def __post_init__(self):
        if not (math.isfinite(self.base) and self.base > 0.0):
            raise ValueError(f"DelayModel.base={self.base} must be finite > 0")
        if not (math.isfinite(self.sigma) and self.sigma >= 0.0):
            raise ValueError(
                f"DelayModel.sigma={self.sigma} must be finite >= 0")
        if not (math.isfinite(self.floor) and self.floor >= 0.0):
            raise ValueError(
                f"DelayModel.floor={self.floor} must be finite >= 0")
        if self.dist not in self._DISTS:
            raise ValueError(
                f"DelayModel.dist={self.dist!r} not in {self._DISTS}")
        if self.dist == "pareto" and not (
                math.isfinite(self.shape) and self.shape > 0.0):
            raise ValueError(
                f"DelayModel.shape={self.shape} must be finite > 0")

    def sample(self, rng: np.random.Generator, n: Optional[int] = None):
        if n is None:  # scalar fast path — the engine hot loop draws ~4/sweep
            if self.dist == "lognormal":
                s = self.base * rng.lognormal(mean=0.0, sigma=self.sigma)
            elif self.dist == "pareto":
                s = self.base * (1.0 + rng.pareto(self.shape))
            else:  # fixed
                s = self.base
            return max(s, self.floor)
        if self.dist == "lognormal":
            s = self.base * rng.lognormal(mean=0.0, sigma=self.sigma, size=n)
        elif self.dist == "pareto":
            s = self.base * (1.0 + rng.pareto(self.shape, size=n))
        else:
            s = np.full(n, self.base)
        return np.maximum(s, self.floor)


class _BufferedSampler:
    """Block-buffered scalar draws from a ``DelayModel``.

    The engine's hot loop draws ~4 scalar delays per sweep; one vectorised
    draw of ``block`` samples amortises numpy's per-call dispatch ~10×.
    Draws still come from the engine's single RNG stream (a refill consumes
    ``block`` generator variates at once), so a run remains a pure function
    of ``EngineConfig.seed`` — the values are the model's distribution
    exactly, only the stream's *interleaving* with other consumers differs
    from scalar draws.
    """

    __slots__ = ("model", "rng", "block", "_buf", "_pos")

    def __init__(self, model: DelayModel, rng: np.random.Generator,
                 block: int = 1024):
        self.model = model
        self.rng = rng
        self.block = block
        self._buf = model.sample(rng, block)
        self._pos = 0

    def __call__(self) -> float:
        pos = self._pos
        if pos == self.block:
            self._buf = self.model.sample(self.rng, self.block)
            pos = 0
        self._pos = pos + 1
        return float(self._buf[pos])


@dataclass(frozen=True)
class EngineConfig:
    compute: DelayModel                    # per-sweep compute duration
    channel: DelayModel                    # per-message network delay
    fifo: bool = False                     # FIFO channel delivery
    hop_latency: float = 5e-5              # reduction/broadcast per-hop latency
    het_factor: float = 0.3                # per-process speed heterogeneity
    max_time: float = 1e9
    max_iters: int = 200_000
    seed: int = 0
    fused: bool = True                     # prefer update_with_residual + skip
                                           # residuals the protocol won't read
    scenario: Optional[Any] = None         # core.scenarios.Scenario — adversarial
                                           # platform effects (None = plain)


# paper-flavoured presets.  Delays are scaled so that interface data and
# reduction rounds span a few sweeps (the paper's runs at 15–20k iterations
# have reductions spanning dozens of iterations — same relative staleness at
# our reduced iteration counts), which is what makes PFAIT's inconsistency
# observable while snapshot records stay consistent.
def stable_platform(compute_base: float = 1e-3) -> EngineConfig:
    """Single-site HPC platform (paper's setting): tight delay distribution."""
    return EngineConfig(
        compute=DelayModel(compute_base, sigma=0.15),
        channel=DelayModel(compute_base * 1.5, sigma=0.4),
        hop_latency=compute_base,
        het_factor=0.15,
    )


def unstable_platform(compute_base: float = 1e-3) -> EngineConfig:
    """Heavy-tailed delays / strong heterogeneity (grid-like)."""
    return EngineConfig(
        compute=DelayModel(compute_base, sigma=0.8),
        channel=DelayModel(compute_base * 3.0, sigma=1.2),
        hop_latency=2 * compute_base,
        het_factor=0.8,
    )


def heavy_tail_platform(compute_base: float = 1e-3) -> EngineConfig:
    """Pareto channel latency (tail index 1.2 ⇒ infinite variance): steady
    compute, but occasional message delays orders of magnitude above the
    median — the WAN/grid regime of the reliability lab."""
    return EngineConfig(
        compute=DelayModel(compute_base, sigma=0.2),
        channel=DelayModel(compute_base * 2.0, dist="pareto", shape=1.2),
        hop_latency=compute_base,
        het_factor=0.3,
    )


PLATFORMS = {
    "stable": stable_platform,
    "unstable": unstable_platform,
    "heavy_tail": heavy_tail_platform,
}


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class Msg:
    src: int
    dst: int
    kind: str          # "data" | "marker" | "snap2" | "snap5" | "confirm5"
    payload: Any = None
    round: int = 0
    send_time: float = 0.0
    nbytes: int = 0


@dataclass
class RunResult:
    terminated: bool
    detect_time: float
    wtime: float
    k_max: int
    k_min: int
    r_star: float
    detected_residual: float
    msg_counts: Dict[str, int]
    msg_bytes: Dict[str, int]
    reductions: int
    protocol: str
    msg_dropped: Dict[str, int] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class AsyncEngine:
    """Discrete-event simulator of asynchronous iterations + detection."""

    def __init__(self, problem: DecomposedProblem, cfg: EngineConfig, protocol,
                 recorder=None):
        self.problem = problem
        self.cfg = cfg
        self.protocol = protocol
        self.scenario = cfg.scenario       # core.scenarios.Scenario | None
        self.recorder = recorder           # core.reliability.TraceRecorder | None
        # per-hook scenario dispatch: skip the per-event call entirely when
        # no effect shapes that hook (identity hooks draw no RNG, so this
        # cannot change a run).  Pruning applies ONLY to the stock
        # effect-composition dispatchers — a Scenario subclass (or
        # duck-typed object) overriding a hook method itself is always
        # called, whatever its effects tuple says.
        sc = cfg.scenario

        def _sc_for(hook: str, effects_attr: str):
            if sc is None:
                return None
            from repro_torch.core.scenarios import Scenario

            if getattr(type(sc), hook, None) is not getattr(Scenario, hook):
                return sc  # custom hook implementation: never prune
            return sc if getattr(sc, effects_attr, True) else None

        self._sc_channel = _sc_for("channel_delay", "channel_effects")
        self._sc_compute = _sc_for("compute_delay", "compute_effects")
        self._sc_pause = _sc_for("paused_until", "pause_effects")
        # send-event observer, resolved once: recorders in lite mode
        # (record_sends=False) skip the per-message callback entirely
        self._send_observer = (
            recorder.on_send
            if recorder is not None and getattr(recorder, "record_sends", True)
            else None)
        self.rng = np.random.default_rng(cfg.seed)
        p = problem.p
        self.p = p
        # fused hot path: feature-detect the optional problem/protocol hooks
        self._use_fused = cfg.fused and callable(
            getattr(problem, "update_with_residual", None)
        )
        self._wants_residual = getattr(protocol, "wants_residual", None)
        # per-process state
        self.x: List[torch.Tensor] = [problem.init_local(i) for i in range(p)]
        self.deps: List[Dict[int, torch.Tensor]] = [dict() for _ in range(p)]
        # plain lists, not ndarrays: the event loop reads these hundreds of
        # thousands of times per run and numpy scalar indexing costs ~5× a
        # list index
        self.k: List[int] = [0] * p
        self.speed = (1.0 + cfg.het_factor * self.rng.random(p)).tolist()
        self.stop_time: List[float] = [math.inf] * p
        self._stop_max = math.inf   # max(stop_time), set once at terminate
        # block-buffered scalar delay draws (hot loop; see _BufferedSampler)
        self._draw_compute = _BufferedSampler(cfg.compute, self.rng)
        self._draw_channel = _BufferedSampler(cfg.channel, self.rng)
        # seed dependency views with initial interfaces (standard: x^0 known)
        for i in range(p):
            for j in problem.neighbors(i):
                self.deps[i][j] = problem.interface(j, self.x[j], i)
        # -- dynamic membership (core.scenarios crash/join/restart) --------
        # Timelines are static (declared at scenario construction), so the
        # member/checkpoint events below are scheduled once here, consume no
        # RNG draws, and leave non-membership runs event-identical.
        self.active: List[bool] = [True] * p
        self.membership_changes = 0
        member_events: Tuple[Tuple[float, str, int], ...] = ()
        if sc is not None and getattr(sc, "elastic", False):
            member_events = sc.membership_events()
            for t_ev, kind_ev, w in member_events:
                if not 0 <= w < p:
                    raise ValueError(
                        f"membership event {kind_ev!r} targets worker {w} "
                        f"outside 0..{p - 1}")
            for w in sc.initially_inactive():
                self.active[w] = False
        self._has_membership = bool(member_events)
        # readmission times per worker (parked compute chains resume there)
        self._resume_at: Dict[int, List[float]] = {}
        # periodic state snapshots backing "restore" events
        self._ckpt_state: List[Optional[Tuple]] = [None] * p
        # event queue
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._counter = itertools.count()
        self._fifo_last: Dict[Tuple[int, int], float] = {}
        if self._has_membership:
            for t_ev, kind_ev, w in member_events:
                if kind_ev in ("join", "restore"):
                    self._resume_at.setdefault(w, []).append(t_ev)
            restores = [t_ev for t_ev, k_ev, _ in member_events
                        if k_ev == "restore"]
            every = getattr(sc, "checkpoint_every", None)
            if restores and every:
                # snapshots are only consumed by restores — schedule the
                # bounded prefix of the cadence, keeping the heap drainable
                n_ckpt = int(math.floor(max(restores) / every)) + 1
                for m in range(1, n_ckpt + 1):
                    self.schedule(m * every, "ckpt", None)
            for t_ev, kind_ev, w in member_events:
                self.schedule(t_ev, "member", (kind_ev, w))
        # accounting
        self.msg_counts: Dict[str, int] = {}
        self.msg_bytes: Dict[str, int] = {}
        self.msg_dropped: Dict[str, int] = {}
        self.reductions_started = 0
        # termination
        self.detect_time: Optional[float] = None
        self.detected_residual: float = float("inf")
        self.now = 0.0
        self._exhaust_deadline: Optional[float] = None

    # -- event plumbing ----------------------------------------------------
    def schedule(self, t: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._heap, (t, next(self._counter), kind, payload))

    def send(self, msg: Msg, t: float) -> None:
        """Send a message over channel (src→dst) honouring FIFO-ness.

        With a scenario attached, the sampled delay passes through
        ``scenario.channel_delay`` — which may inflate it (bursts, tail
        spikes) or return None to drop the message entirely (lossy
        channels).  Dropped messages are accounted in ``msg_dropped`` and
        never delivered."""
        delay = self._draw_channel()
        if self._sc_channel is not None:
            shaped = self._sc_channel.channel_delay(t, msg.kind, delay, self.rng)
            if shaped is None:
                msg.send_time = t
                self.msg_dropped[msg.kind] = self.msg_dropped.get(msg.kind, 0) + 1
                if self._send_observer is not None:
                    self._send_observer(self, msg, t, None)
                return
            delay = float(shaped)
        deliver = t + delay
        if self.cfg.fifo:
            key = (msg.src, msg.dst)
            deliver = max(deliver, self._fifo_last.get(key, 0.0) + 1e-12)
            self._fifo_last[key] = deliver
        msg.send_time = t
        if msg.nbytes == 0:
            p = msg.payload
            if isinstance(p, torch.Tensor):
                msg.nbytes = p.nbytes
            else:
                msg.nbytes = int(np.asarray(p).nbytes) if p is not None else 16
        self.msg_counts[msg.kind] = self.msg_counts.get(msg.kind, 0) + 1
        self.msg_bytes[msg.kind] = self.msg_bytes.get(msg.kind, 0) + msg.nbytes
        if self._send_observer is not None:
            self._send_observer(self, msg, t, deliver)
        self.schedule(deliver, "deliver", msg)

    def _send_data(self, i: int, j: int, t: float) -> None:
        """Data-message send with the payload built lazily *after* the drop
        decision: under lossy scenarios (interface blackout drops every data
        message) the interface extraction and Msg construction of a dropped
        message are pure overhead — the engine never counts their bytes.
        Draw order (delay, then scenario) matches ``send`` exactly."""
        delay = self._draw_channel()
        if self._sc_channel is not None:
            shaped = self._sc_channel.channel_delay(t, "data", delay, self.rng)
            if shaped is None:
                self.msg_dropped["data"] = self.msg_dropped.get("data", 0) + 1
                if self._send_observer is not None:
                    self._send_observer(
                        self, Msg(src=i, dst=j, kind="data", send_time=t),
                        t, None)
                return
            delay = float(shaped)
        deliver = t + delay
        if self.cfg.fifo:
            key = (i, j)
            deliver = max(deliver, self._fifo_last.get(key, 0.0) + 1e-12)
            self._fifo_last[key] = deliver
        payload = self.problem.interface(i, self.x[i], j)
        msg = Msg(src=i, dst=j, kind="data", payload=payload,
                  send_time=t, nbytes=payload.nbytes)
        self.msg_counts["data"] = self.msg_counts.get("data", 0) + 1
        self.msg_bytes["data"] = self.msg_bytes.get("data", 0) + payload.nbytes
        if self._send_observer is not None:
            self._send_observer(self, msg, t, deliver)
        self.schedule(deliver, "deliver", msg)

    # -- reduction service ---------------------------------------------------
    def start_reduction(
        self,
        sample_fn: Callable[[int, float], float],
        on_complete: Callable[[np.ndarray, float], None],
        t: float,
    ) -> None:
        """Non-blocking tree reduction: contribution of worker i is sampled at
        a staggered time (this is the PFAIT inconsistency), completion fires
        2·ceil(log2 p)·hop after the last contribution.

        Under dynamic membership the reduction spans the workers active at
        *launch* (offset draws still cover all p slots, so the RNG stream is
        membership-independent): a worker that crashes before its sample
        time contributes NaN (the combiner skips it), one that joins
        mid-reduction waits for the next launch."""
        self.reductions_started += 1
        offsets = self.cfg.channel.sample(self.rng, self.p)
        if self._sc_channel is not None:
            # collectives are lossless-but-slow: scenario effects shape the
            # staggered sampling offsets (kind="reduce") but never drop them
            offsets = np.array([
                shaped if (shaped := self._sc_channel.channel_delay(
                    t, "reduce", float(o), self.rng)) is not None else float(o)
                for o in offsets
            ])
        sample_times = t + offsets
        contribs = np.full(self.p, np.nan)
        active = self.active
        participants = [i for i in range(self.p) if active[i]]
        if not participants:
            return  # empty membership: nothing to reduce, never completes
        remaining = [len(participants)]

        def make_sampler(i, ts):
            def fire(_):
                if active[i]:
                    contribs[i] = sample_fn(i, ts)
                remaining[0] -= 1
                if remaining[0] == 0:
                    done_t = float(max(
                        float(sample_times[j]) for j in participants
                    )) + 2 * math.ceil(
                        math.log2(max(self.p, 2))
                    ) * self.cfg.hop_latency
                    self.schedule(done_t, "callback", lambda tt: on_complete(contribs, tt))

            return fire

        for i in participants:
            self.schedule(float(sample_times[i]), "callback", make_sampler(i, float(sample_times[i])))

    # -- termination ---------------------------------------------------------
    def terminate(self, t: float, detected_residual: float) -> None:
        if self.detect_time is not None:
            return
        self.detect_time = t
        self.detected_residual = detected_residual
        if self.recorder is not None:
            self.recorder.on_detect(self, t, detected_residual)
        bcast = math.ceil(math.log2(max(self.p, 2))) * self.cfg.hop_latency
        for i in range(self.p):
            self.stop_time[i] = t + bcast + self._draw_channel()
        self._stop_max = max(self.stop_time)

    # -- main loop -------------------------------------------------------------
    def run(self) -> RunResult:
        cfg = self.cfg
        for i in range(self.p):
            if not self.active[i]:
                continue  # late joiners sweep from their admission event
            dt = self._draw_compute() * self.speed[i]
            if self._sc_compute is not None:
                dt = self._sc_compute.compute_delay(0.0, i, dt, self.rng)
            self.schedule(dt, "compute", i)
        self.protocol.on_start(self, 0.0)

        # hot-loop locals: the dispatcher pops hundreds of thousands of
        # events per run, and attribute lookups at that rate are a
        # measurable slice of every reliability-matrix cell
        heap = self._heap
        heappop_, heappush_ = heapq.heappop, heapq.heappush
        counter = self._counter
        k, x, deps, stop_time = self.k, self.x, self.deps, self.stop_time
        speed = self.speed
        problem = self.problem
        neighbors = [problem.neighbors(i) for i in range(self.p)]
        max_iters, max_time = cfg.max_iters, cfg.max_time
        use_fused, wants_residual = self._use_fused, self._wants_residual
        update_with_residual = getattr(problem, "update_with_residual", None)
        update, local_residual = problem.update, problem.local_residual
        protocol = self.protocol
        on_iteration, on_data, on_message = (
            protocol.on_iteration, protocol.on_data, protocol.on_message)
        recorder = self.recorder
        sc_pause, sc_compute = self._sc_pause, self._sc_compute
        draw_compute = self._draw_compute
        send_data = self._send_data
        rng = self.rng
        nan = float("nan")
        active = self.active  # mutated in place by _apply_membership

        while heap:
            t, _, kind, payload = heappop_(heap)
            self.now = t
            if t > max_time:
                break
            if self.detect_time is not None and t > self._stop_max:
                break
            if (self._exhaust_deadline is not None
                    and self.detect_time is None
                    and t > self._exhaust_deadline):
                # every worker hit max_iters and no detection fired within
                # the grace window: the state is frozen, so endlessly
                # relaunching reductions (PFAIT) would never terminate —
                # return undetected instead of hanging
                break
            if kind == "compute":
                i = payload
                if not active[i]:
                    # crashed worker: park the compute chain at its next
                    # readmission (restore/join) time, or sever it for good
                    # — parking keeps readmitted workers on ONE chain (no
                    # duplicate scheduling, no extra RNG draws)
                    for rt in self._resume_at.get(i, ()):
                        if rt > t:
                            heappush_(heap, (rt, next(counter), "compute", i))
                            break
                    continue
                if sc_pause is not None:
                    resume = sc_pause.paused_until(t, i)
                    if resume is not None and resume > t:
                        # mid-run pause: the sweep that would have started
                        # now is deferred to the resume time
                        heappush_(heap, (resume, next(counter), "compute", i))
                        continue
                if t > stop_time[i] or k[i] >= max_iters:
                    if (k[i] >= max_iters
                            and self._exhaust_deadline is None
                            and min(kk for kk, al in zip(k, active)
                                    if al) >= max_iters):
                        # grace: let in-flight data drain + a few reduction
                        # rounds sample the final (now frozen) state (over
                        # the *active* membership — a crashed worker's
                        # frozen counter must not block exhaustion)
                        self._exhaust_deadline = t + 100 * (
                            cfg.channel.base + cfg.hop_latency
                        )
                    continue
                if use_fused:
                    need_r = (wants_residual is None
                              or wants_residual(self, i))
                    x[i], r_i = update_with_residual(
                        i, x[i], deps[i], need_residual=need_r
                    )
                    if r_i is None:
                        r_i = nan  # protocol declared it unused
                else:
                    x[i] = update(i, x[i], deps[i])
                    r_i = local_residual(i, x[i], deps[i])
                k[i] += 1
                for j in neighbors[i]:
                    send_data(i, j, t)
                if recorder is not None:
                    recorder.on_sweep(self, t, i)
                on_iteration(self, i, t, r_i)
                dt = draw_compute() * speed[i]
                if sc_compute is not None:
                    dt = sc_compute.compute_delay(t, i, dt, rng)
                heappush_(heap, (t + dt, next(counter), "compute", i))
            elif kind == "deliver":
                msg: Msg = payload
                if not active[msg.dst]:
                    continue  # messages to crashed/absent workers are lost
                if msg.kind == "data":
                    if t <= stop_time[msg.dst]:
                        deps[msg.dst][msg.src] = msg.payload
                        on_data(self, msg, t)
                else:
                    on_message(self, msg, t)
            elif kind == "callback":
                payload(t)
            elif kind == "member":
                self._apply_membership(payload, t)
            elif kind == "ckpt":
                self._take_checkpoint(t)

        wtime = self._stop_max if self.detect_time is not None else self.now
        r_star = self.problem.exact_residual(self.x)
        result = RunResult(
            terminated=self.detect_time is not None,
            detect_time=self.detect_time if self.detect_time is not None else float("inf"),
            wtime=wtime,
            k_max=int(max(self.k)),
            k_min=int(min(self.k)),
            r_star=float(r_star),
            detected_residual=float(self.detected_residual),
            msg_counts=dict(self.msg_counts),
            msg_bytes=dict(self.msg_bytes),
            reductions=self.reductions_started,
            protocol=type(self.protocol).__name__,
            msg_dropped=dict(self.msg_dropped),
        )
        if self.recorder is not None:
            self.recorder.on_finish(self, result)
        return result

    # -- dynamic membership -------------------------------------------------
    def _apply_membership(self, ev: Tuple[str, int], t: float) -> None:
        kind, w = ev
        if kind == "crash":
            if not self.active[w]:
                return
            self.active[w] = False
        else:  # "join" | "restore"
            if self.active[w]:
                return
            if kind == "restore":
                snap = self._ckpt_state[w]
                if snap is not None:
                    x_w, deps_w, _k_w = snap
                    self.x[w] = x_w.clone()
                    self.deps[w] = {j: a.clone()
                                    for j, a in deps_w.items()}
                else:
                    # crashed before the first snapshot: cold restart from
                    # the initial state (x^0 + t=0 interface views)
                    self.x[w] = self.problem.init_local(w)
                    self.deps[w] = {
                        j: self.problem.interface(
                            j, self.problem.init_local(j), w)
                        for j in self.problem.neighbors(w)}
            self.active[w] = True
            if kind == "join":
                # late joiner: no compute chain exists yet — start one.
                # (A restored worker's chain was parked by the event loop
                # and resumes at this instant on its own.)
                dt = self._draw_compute() * self.speed[w]
                if self._sc_compute is not None:
                    dt = self._sc_compute.compute_delay(t, w, dt, self.rng)
                self.schedule(t + dt, "compute", w)
        self.membership_changes += 1
        if self.recorder is not None:
            hook = getattr(self.recorder, "on_membership", None)
            if hook is not None:
                hook(self, t, kind, w)
        hook = getattr(self.protocol, "on_membership", None)
        if hook is not None:
            hook(self, t, kind, w)

    def _take_checkpoint(self, t: float) -> None:
        for i in range(self.p):
            if self.active[i]:
                self._ckpt_state[i] = (
                    self.x[i].clone(),
                    {j: a.clone()
                     for j, a in self.deps[i].items()},
                    self.k[i],
                )

    def active_workers(self) -> List[int]:
        return [i for i in range(self.p) if self.active[i]]

    def exact_active_residual(self, xs: Optional[Sequence] = None) -> float:
        """Exact residual of the *active* subsystem: contributions from
        active workers only, with fresh interface views assembled from
        ``xs`` (default: live state) for active neighbours.  This is the
        ground truth a detection claim is scored against once the
        membership has changed — inactive blocks are boundary data, not
        unknowns (dynamic asynchronous iterations converge to the fixed
        point of the active subsystem).

        An *inactive* neighbour's boundary value is the receiver's frozen
        delivered view (``deps[i][j]``), not ``interface(x_j)``: over
        non-FIFO channels the dead worker's final interface message can be
        overtaken by an older one, so the survivors' fixed point is defined
        by what was actually delivered — the dead block's final state is
        unobservable to any detector, oracle included."""
        xs = self.x if xs is None else xs
        prob = self.problem
        active = self.active
        contribs = []
        for i in range(self.p):
            if not active[i]:
                continue
            deps_i = {j: (prob.interface(j, xs[j], i) if active[j]
                          else self.deps[i][j])
                      for j in prob.neighbors(i)}
            contribs.append(prob.local_residual(i, xs[i], deps_i))
        return float(combine_contributions(contribs, prob.ord))

    # convenience for protocols
    def live_local_residual(self, i: int) -> float:
        fast = getattr(self.problem, "local_residual_fast", None)
        if self._use_fused and callable(fast):
            return fast(i, self.x[i], self.deps[i])
        return self.problem.local_residual(i, self.x[i], self.deps[i])
