"""Detection as a service, and LM serving with the paper's detection at
batch level (port of ``launch/serve.py``).

The multi-tenant detection service packs many independent fixed-point
tenants into the lanes of one batched device program:

* **Admission** — tenants submit ConvDiff, PageRank or mlfixed problems
  with their own ε̃, monitor mode, staleness K and persistence m
  (``TenantSpec``).  Invalid requests are rejected at admission with a
  structured error record and never reach a lane.
* **Lane packing** — tenants of one signature (family, problem shape,
  monitor mode) share a ``_LaneBucket``: a ``detection.make_lane_runner``
  chunk program over the family's ``update_with_residual_batched``.
  Padding lanes are inert (ε = −1 on a non-negative residual never
  fires); a tenant that detects is retired and its lane refilled in place
  (``detection.reset_lanes`` copied into the bucket's buffers), so the
  runner is never rebuilt.  On the card the runner is one CUDA graph per
  signature, captured at its first chunk and replayed after.
* **Warm sharing** — runners are keyed by SHA-256 over the signature JSON
  and a fingerprint of the sources that define them: the service builds
  one per signature, not per tenant (``compile_count``, ``warm_hits``).
* **Reporting** — ``DetectionService.report()`` returns a
  ``runtime.api.ServeReport``: each tenant's detection scored against its
  exact residual trace (``core.termination``; the batched step is
  synchronous, so the σ-applied series is that trace), queue waits and
  nearest-rank p50/p95/p99 time to detection in ticks, and throughput.
* **Shutdown/drain** — ``shutdown(drain=True)`` stops admission, lets the
  lanes in flight finish (bounded by the step budget) and sheds the queue.

``generate`` / ``serve``: batched prefill, then greedy decode that stops on
a K-stale "all sequences finished" indicator through the PFAIT monitor.

    PYTHONPATH=src python -m repro_torch.launch.serve --detection-demo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import reduced as reduced_cfg
from repro_torch.configs.registry import get_arch
from repro_torch.core import detection, termination
from repro_torch.models.model import Model
from repro_torch.models.transformer import Transformer
from repro_torch.runtime.api import ServeReport, TenantReport
from repro_torch.solvers import convdiff, mlfixed, pagerank

#: problem families the service admits (each has lane_x0/lane_operands
#: and an ``update_with_residual_batched`` batched step)
SERVE_FAMILIES = ("convdiff", "pagerank", "mlfixed")

#: padding-lane threshold: residual contributions are non-negative and the
#: ring starts at +inf, so a lane with ε = −1 can never fire
_PAD_EPS = -1.0

_REJECT = "rejected"


def make_serve_problem(family: str, seed: int = 0, **kw):
    """Problem factory over the servable families."""
    if family == "convdiff":
        return convdiff.ConvDiffProblem(seed=seed, **kw)
    if family == "pagerank":
        return pagerank.PageRankProblem(seed=seed, **kw)
    if family == "mlfixed":
        return mlfixed.MLFixedPointProblem(seed=seed, **kw)
    raise KeyError(f"family {family!r} not in {SERVE_FAMILIES}")


@dataclass(frozen=True)
class ServeConfig:
    """Service-level knobs (every tenant in a bucket shares them).

    ``lanes`` is the batch width of one lane runner, ``chunk`` the device
    steps per service tick, ``max_staleness`` the largest per-tenant K the
    service accepts (the shared monitor ring is padded to K+1), and
    ``max_steps`` the per-tenant step budget before a tenant that has not
    detected is retired with status ``"timeout"``.
    """

    lanes: int = 8
    chunk: int = 16
    max_staleness: int = 8
    max_steps: int = 4096
    margin: float = 10.0          # default PFAIT margin (ε = ε̃ / margin)
    oracle_factor: float = 10.0   # decade factor for false-detection scoring

    def __post_init__(self):
        if self.lanes < 1 or self.chunk < 1:
            raise ValueError(f"lanes={self.lanes}/chunk={self.chunk} must be >= 1")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness={self.max_staleness} must be >= 0")
        if self.max_steps < self.chunk:
            raise ValueError(
                f"max_steps={self.max_steps} must be >= chunk={self.chunk}")

    @property
    def ring_len(self) -> int:
        """Monitor ring length shared by every lane (max K + 1)."""
        return self.max_staleness + 1


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's solve request.

    ``problem`` holds the family's constructor kwargs *minus* the seed
    (the seed is per-tenant data; everything else defines the shape
    bucket).  ``margin=None`` inherits the service default; the threshold
    follows ``detection.for_mode``: ε = ε̃/margin for pfait, ε̃ otherwise.
    """

    tenant: str
    family: str
    problem: Mapping[str, Any] = field(default_factory=dict)
    seed: int = 0
    eps_tilde: float = 1e-6
    mode: str = "pfait"
    staleness: int = 2
    persistence: int = 4
    margin: Optional[float] = None


# ---------------------------------------------------------------------------
# Content-addressed runner signatures
# ---------------------------------------------------------------------------

_FINGERPRINT_CACHE: Dict[str, str] = {}


def executable_fingerprint() -> str:
    """SHA-256 over the sources that define a lane runner: the detection
    layer, the three solver families and this module.  Editing any of them
    gives new keys."""
    cached = _FINGERPRINT_CACHE.get("fp")
    if cached is not None:
        return cached
    h = hashlib.sha256()
    for mod in (detection, convdiff, pagerank, mlfixed):
        with open(mod.__file__, "rb") as f:
            h.update(f.read())
    with open(__file__, "rb") as f:
        h.update(f.read())
    _FINGERPRINT_CACHE["fp"] = h.hexdigest()
    return _FINGERPRINT_CACHE["fp"]


def _canonical(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def signature_of(spec: TenantSpec, cfg: ServeConfig) -> Dict[str, Any]:
    """The shape-bucket signature a tenant packs under: family + problem
    kwargs (seed excluded) + monitor mode + the service batch geometry."""
    return {
        "family": spec.family,
        "problem": {k: spec.problem[k] for k in sorted(spec.problem)},
        "mode": spec.mode,
        "lanes": cfg.lanes,
        "chunk": cfg.chunk,
        "ring": cfg.ring_len,
    }


def signature_key(sig: Dict[str, Any]) -> str:
    """Content-addressed runner key: signature JSON + code fingerprint."""
    payload = {"sig": sig, "code": executable_fingerprint()}
    return hashlib.sha256(_canonical(payload).encode()).hexdigest()


def _sigma_np(raw: np.ndarray, ord_: float) -> np.ndarray:
    """Host-side σ of a raw contribution series (numpy twin of
    ``detection._sigma_lane``), in f64."""
    raw = np.asarray(raw, dtype=np.float64)
    if np.isinf(ord_):
        return raw
    if ord_ == 2.0:
        return np.sqrt(raw)
    return raw ** (1.0 / ord_)


# ---------------------------------------------------------------------------
# Lane bucket — one lane runner, `lanes` resident detection lanes
# ---------------------------------------------------------------------------


class _ActiveTenant:
    """Book-keeping for a tenant occupying a lane."""

    __slots__ = ("spec", "arrival_tick", "admit_tick", "steps", "chunks", "ord")

    def __init__(self, spec: TenantSpec, arrival_tick: int, admit_tick: int,
                 ord_: float):
        self.spec = spec
        self.arrival_tick = arrival_tick
        self.admit_tick = admit_tick
        self.steps = 0
        self.chunks: List[np.ndarray] = []   # raw per-chunk contributions
        self.ord = ord_


class _LaneBucket:
    """One lane runner and its resident lanes.

    Every tensor the runner reads — ``X``, the operands, the lane state and
    the per-lane ε / ε̃ / K / m — is a persistent buffer on the service's
    device, written in place on admit and release (a rebind would detach a
    captured graph's inputs).
    """

    def __init__(self, key: str, sig: Dict[str, Any], runner, prob0,
                 cfg: ServeConfig, device: torch.device):
        self.key = key
        self.sig = sig
        self.runner = runner
        self.prob0 = prob0
        self.cfg = cfg
        self.ord = float(prob0.ord)
        L = cfg.lanes
        f32 = dict(dtype=torch.float32, device=device)
        self.X = torch.zeros((L,) + np.shape(prob0.lane_x0()), **f32)
        self.ops = {k: torch.zeros((L,) + np.shape(v), **f32)
                    for k, v in prob0.lane_operands().items()}
        self.eps = torch.full((L,), _PAD_EPS, **f32)
        self.epst = torch.full((L,), _PAD_EPS, **f32)
        self.K = torch.zeros((L,), dtype=torch.int32, device=device)
        self.m = torch.ones((L,), dtype=torch.int32, device=device)
        self.state = detection.init_lanes(L, cfg.ring_len, device)
        self.active: List[Optional[_ActiveTenant]] = [None] * L

    @property
    def free_lanes(self) -> List[int]:
        return [i for i, a in enumerate(self.active) if a is None]

    @property
    def busy(self) -> bool:
        return any(a is not None for a in self.active)

    def _reset(self, lane: int) -> None:
        mask = torch.zeros(self.cfg.lanes, dtype=torch.bool)
        mask[lane] = True
        for dst, src in zip(self.state, detection.reset_lanes(self.state, mask)):
            dst.copy_(src)

    def admit(self, spec: TenantSpec, prob, arrival_tick: int,
              admit_tick: int, margin_default: float) -> None:
        """Pack one tenant into a free lane (caller guarantees one)."""
        lane = self.free_lanes[0]
        margin = margin_default if spec.margin is None else spec.margin
        eps = detection.for_mode(spec.mode, spec.eps_tilde, margin=margin).eps
        self.X[lane].copy_(torch.as_tensor(np.asarray(prob.lane_x0(), np.float32)))
        for k, v in prob.lane_operands().items():
            self.ops[k][lane].copy_(torch.as_tensor(np.asarray(v, np.float32)))
        self.eps[lane] = float(np.float32(eps))
        self.epst[lane] = float(np.float32(spec.eps_tilde))
        self.K[lane] = 0 if spec.mode == "sync" else int(spec.staleness)
        self.m[lane] = int(spec.persistence)
        self._reset(lane)
        self.active[lane] = _ActiveTenant(spec, arrival_tick, admit_tick, self.ord)

    def run_chunk(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Advance every lane one chunk; returns the lanes' converged flags,
        detect steps and detected residuals and the chunk's raw series
        ``[L, chunk]``, on the host."""
        _, state, cs = self.runner(self.X, self.ops, self.state, self.eps,
                                   self.epst, self.K, self.m)
        return (cs.cpu().numpy(), state.converged.cpu().numpy(),
                state.detect_step.cpu().numpy(), state.detected.cpu().numpy())

    def release(self, lane: int) -> None:
        """Retire a lane back to inert padding (its operand rows stay: ε = −1
        keeps its monitor unfireable, and a refill overwrites them)."""
        self.eps[lane] = _PAD_EPS
        self.epst[lane] = _PAD_EPS
        self.K[lane] = 0
        self.m[lane] = 1
        self._reset(lane)
        self.active[lane] = None


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class DetectionService:
    """Continuous multi-tenant detection service (see the module docstring)
    on ``device`` (the card unless the caller asks for the CPU).

    Drive it with ``submit()`` + ``step_tick()`` (or ``serve_detection``),
    then ``report()``.  Scheduling is deterministic in the tick domain for
    a fixed submission sequence.
    """

    def __init__(self, cfg: ServeConfig = ServeConfig(), device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tick_count = 0
        self.compile_count = 0
        self.warm_hits = 0
        self.reports: List[TenantReport] = []
        self._runners: Dict[str, Any] = {}      # warm-runner registry
        self._buckets: Dict[str, _LaneBucket] = {}
        self._queues: Dict[str, List[Tuple[TenantSpec, Any, int]]] = {}
        self._accepting = True
        self._wall_s = 0.0
        self._pack_s = 0.0                         # admission into lanes
        self._family_s: Counter = Counter()        # chunk wall per family
        self._family_steps: Counter = Counter()    # lane-steps per family

    # -- admission -----------------------------------------------------------

    def submit(self, spec: TenantSpec,
               arrival_tick: Optional[int] = None) -> Dict[str, Any]:
        """Admit one tenant (validated) or reject it with a structured
        error record ``{"tenant", "admitted", "error", "reason"}``.

        Validation happens entirely at admission, including constructing
        the seeded problem, so a malformed spec cannot reach a lane.
        """
        arrival = self.tick_count if arrival_tick is None else int(arrival_tick)
        err = self._validate(spec)
        if err is None and not self._accepting:
            err = ("shutdown", "service is no longer accepting tenants")
        prob = None
        if err is None:
            try:
                prob = make_serve_problem(spec.family, seed=int(spec.seed),
                                          **dict(spec.problem))
            except (TypeError, ValueError) as exc:  # the constructors' validation
                err = ("problem_invalid", f"{type(exc).__name__}: {exc}")
        if err is not None:
            code, reason = err
            self.reports.append(TenantReport(
                tenant=spec.tenant, status=_REJECT if code != "shutdown" else "shed",
                family=spec.family, mode=spec.mode,
                eps_tilde=float(spec.eps_tilde),
                arrival_tick=arrival, error=code, reason=reason))
            return {"tenant": spec.tenant, "admitted": False,
                    "error": code, "reason": reason}
        key = signature_key(signature_of(spec, self.cfg))
        self._queues.setdefault(key, []).append((spec, prob, arrival))
        return {"tenant": spec.tenant, "admitted": True, "error": None,
                "reason": None, "signature": key}

    def _validate(self, spec: TenantSpec) -> Optional[Tuple[str, str]]:
        if spec.family not in SERVE_FAMILIES:
            return ("unknown_family",
                    f"family {spec.family!r} not in {SERVE_FAMILIES}")
        if spec.mode not in detection.MODES:
            return ("unknown_mode",
                    f"mode {spec.mode!r} not in {detection.MODES}")
        if not (np.isfinite(spec.eps_tilde) and spec.eps_tilde > 0):
            return ("bad_eps", f"eps_tilde={spec.eps_tilde!r} must be finite > 0")
        if spec.mode != "sync" and not (
                0 <= int(spec.staleness) <= self.cfg.max_staleness):
            return ("bad_staleness",
                    f"staleness={spec.staleness} outside [0, "
                    f"{self.cfg.max_staleness}]")
        if int(spec.persistence) < 1:
            return ("bad_persistence",
                    f"persistence={spec.persistence} must be >= 1")
        if spec.margin is not None and spec.margin < 1.0:
            return ("bad_margin", f"margin={spec.margin} must be >= 1")
        return None

    # -- lane packing + the tick loop ----------------------------------------

    def _runner_for(self, key: str, sig: Dict[str, Any], prob0):
        """Warm-runner registry: one runner per signature, ever (on the
        card, one CUDA-graph capture at its first chunk)."""
        runner = self._runners.get(key)
        if runner is not None:
            self.warm_hits += 1
            return runner

        def step_fn(X, ops):
            return prob0.update_with_residual_batched(X, **ops)

        runner = detection.make_lane_runner(
            sig["mode"], step_fn, sig["chunk"], ord=float(prob0.ord))
        self._runners[key] = runner
        self.compile_count += 1
        return runner

    def _pack(self) -> None:
        for key, queue in self._queues.items():
            if not queue:
                continue
            bucket = self._buckets.get(key)
            if bucket is None:
                spec0, prob0, _ = queue[0]
                sig = signature_of(spec0, self.cfg)
                runner = self._runner_for(key, sig, prob0)
                bucket = _LaneBucket(key, sig, runner, prob0, self.cfg, self.device)
                self._buckets[key] = bucket
            else:
                # a live bucket IS the warm runner for its signature
                self.warm_hits += len(queue[:len(bucket.free_lanes)])
            while queue and bucket.free_lanes:
                spec, prob, arrival = queue.pop(0)
                bucket.admit(spec, prob, arrival, self.tick_count, self.cfg.margin)

    def step_tick(self) -> None:
        """One service tick: pack free lanes from the queues, then advance
        every busy bucket one chunk and harvest converged/expired lanes."""
        t0 = time.perf_counter()
        self._pack()
        self._pack_s += time.perf_counter() - t0
        for bucket in self._buckets.values():
            if not bucket.busy:
                continue
            tc, captured = time.perf_counter(), bucket.runner.capture_s
            cs, conv, dstep, detected = bucket.run_chunk()
            family = bucket.sig["family"]
            # a capture is the runner's build, not a chunk
            self._family_s[family] += (time.perf_counter() - tc
                                       - (bucket.runner.capture_s - captured))
            self._family_steps[family] += self.cfg.chunk * (
                self.cfg.lanes - len(bucket.free_lanes))
            for lane, tenant in enumerate(bucket.active):
                if tenant is None:
                    continue
                tenant.chunks.append(cs[lane])
                tenant.steps += self.cfg.chunk
                if conv[lane]:
                    self._retire(bucket, lane, "served",
                                 int(dstep[lane]), float(detected[lane]))
                elif tenant.steps >= self.cfg.max_steps:
                    self._retire(bucket, lane, "timeout", None, None)
        self.tick_count += 1
        self._wall_s += time.perf_counter() - t0

    def _retire(self, bucket: _LaneBucket, lane: int, status: str,
                detect_step: Optional[int], detected: Optional[float]) -> None:
        tenant = bucket.active[lane]
        spec = tenant.spec
        raw = np.concatenate(tenant.chunks)[: tenant.steps]
        series = _sigma_np(raw, tenant.ord)
        oracle = termination.oracle_detect_step(series, spec.eps_tilde)
        false = False
        if status == "served":
            false = not termination.detection_consistent(
                detect_step, series, spec.eps_tilde, factor=self.cfg.oracle_factor)
        done = self.tick_count + 1   # harvested at the end of this tick
        self.reports.append(TenantReport(
            tenant=spec.tenant, status=status, family=spec.family,
            mode=spec.mode, eps_tilde=float(spec.eps_tilde),
            converged=(status == "served"),
            detect_step=detect_step, detected_residual=detected,
            steps=tenant.steps,
            arrival_tick=tenant.arrival_tick,
            admit_tick=tenant.admit_tick, done_tick=done,
            queue_wait_ticks=tenant.admit_tick - tenant.arrival_tick,
            ttd_ticks=done - tenant.arrival_tick,
            oracle_step=oracle, false_detection=false,
            signature=bucket.key, series=raw))
        bucket.release(lane)

    # -- lifecycle -----------------------------------------------------------

    @property
    def wall_s(self) -> float:
        """Wall seconds spent in ticks so far (admission excluded)."""
        return self._wall_s

    def wall_breakdown(self) -> Dict[str, float]:
        """Where the ticks' wall seconds went: ``pack`` (admission into
        lanes: operand copies, lane resets), ``capture`` (the runners'
        warm-up and CUDA-graph capture), ``chunks`` (the buckets' chunks
        and the host reads after them, captures excluded) and ``other``
        (harvest, retire and scoring)."""
        capture = sum(r.capture_s for r in self._runners.values())
        chunks = sum(self._family_s.values())
        return {"pack": self._pack_s, "capture": capture, "chunks": chunks,
                "other": self._wall_s - self._pack_s - capture - chunks}

    @property
    def busy(self) -> bool:
        """True while any lane is occupied or any tenant is queued."""
        return (any(b.busy for b in self._buckets.values())
                or any(self._queues.values()))

    def run(self, max_ticks: Optional[int] = None) -> None:
        """Tick until drained (or ``max_ticks`` more ticks have elapsed)."""
        end = None if max_ticks is None else self.tick_count + int(max_ticks)
        while self.busy and (end is None or self.tick_count < end):
            self.step_tick()

    def shutdown(self, drain: bool = True) -> None:
        """Stop admission; optionally drain.

        With ``drain=True`` every lane in flight completes (bounded by the
        per-tenant ``max_steps`` budget) and reports; tenants still queued
        are shed either way — a shutdown must not start new work.
        """
        self._accepting = False
        for queue in self._queues.values():
            for spec, _, arrival in queue:
                self.reports.append(TenantReport(
                    tenant=spec.tenant, status="shed", family=spec.family,
                    mode=spec.mode, eps_tilde=float(spec.eps_tilde),
                    arrival_tick=arrival, error="shutdown",
                    reason="queued at shutdown"))
            queue.clear()
        if drain:
            # max_steps bounds every lane, so this loop terminates
            while any(b.busy for b in self._buckets.values()):
                self.step_tick()

    # -- reporting -----------------------------------------------------------

    def report(self) -> ServeReport:
        """Assemble the service-level ``ServeReport``."""
        served = [r for r in self.reports if r.status == "served"]
        timeouts = sum(r.status == "timeout" for r in self.reports)
        ttd = [r.ttd_ticks for r in served]
        qw = [r.queue_wait_ticks for r in served]
        wall = self._wall_s
        throughput = {
            "tenants_per_tick": (len(served) / self.tick_count
                                 if self.tick_count else 0.0),
            "tenants_per_s": len(served) / wall if wall > 0 else 0.0,
            "ms_per_tick": 1e3 * wall / self.tick_count if self.tick_count else 0.0,
        }
        for family, secs in self._family_s.items():
            throughput[f"lane_steps_per_s/{family}"] = (
                self._family_steps[family] / secs if secs > 0 else 0.0)
        return ServeReport(
            converged=bool(served) and timeouts == 0,
            detected_residual=None, detect_step=None,
            outer_iters=self.tick_count,
            residual_history=np.empty(0),
            wall_segments=[("serve", wall)],
            trace=None, membership_log=[], x=None, raw=None,
            tenants=list(self.reports),
            served=len(served),
            rejected=sum(r.status == _REJECT for r in self.reports),
            shed=sum(r.status == "shed" for r in self.reports),
            timeouts=timeouts,
            false_detections=sum(r.false_detection for r in self.reports),
            compile_count=self.compile_count,
            warm_hits=self.warm_hits,
            ticks=self.tick_count,
            queue_wait_ticks=_percentiles(qw),
            ttd_ticks=_percentiles(ttd),
            throughput=throughput,
        )


def _percentiles(xs: Sequence[float]) -> Dict[str, float]:
    """Nearest-rank percentiles (deterministic integers in, integers out)."""
    if not xs:
        return {}
    s = sorted(xs)
    out = {}
    for q in (50, 95, 99):
        rank = max(int(np.ceil(q / 100.0 * len(s))) - 1, 0)
        out[f"p{q}"] = float(s[rank])
    return out


def serve_detection(requests: Sequence[Tuple[TenantSpec, int]],
                    cfg: ServeConfig = ServeConfig(),
                    device: DeviceLike = None,
                    on_tick: Optional[Callable[[DetectionService], None]] = None
                    ) -> ServeReport:
    """Open-loop entry point: play ``(spec, arrival_tick)`` requests into a
    fresh service on ``device``, tick until everything (queue + lanes)
    drains, and return the ``ServeReport``.

    Arrivals are sorted by tick; the service idles through gaps in the
    schedule, so queue waits are measured against the *requested* arrival
    time (the open-loop convention of a Poisson load generator).
    ``on_tick(service)`` runs after every tick (instrumentation, such as a
    profiler's ``step``).
    """
    pending = sorted(requests, key=lambda ra: (ra[1], ra[0].tenant))
    svc = DetectionService(cfg, device=device)
    i = 0
    while i < len(pending) or svc.busy:
        while i < len(pending) and pending[i][1] <= svc.tick_count:
            spec, arrival = pending[i]
            svc.submit(spec, arrival_tick=arrival)
            i += 1
        svc.step_tick()
        if on_tick is not None:
            on_tick(svc)
    svc.shutdown(drain=True)
    return svc.report()


# ---------------------------------------------------------------------------
# LM decode serving — K-stale batch termination
# ---------------------------------------------------------------------------


def make_prompts(vocab_size: int, batch: int, prompt_len: int, seed: int,
                 frontend_dim: int = 0) -> np.ndarray:
    """The JAX server's prompts: ``default_rng(seed).integers(3, vocab)``
    token ids [B, S], or with a frontend (``frontend_dim`` > 0) its
    ``standard_normal`` embeddings [B, S, F] in f32."""
    rng = np.random.default_rng(seed)
    if frontend_dim:
        return rng.standard_normal((batch, prompt_len, frontend_dim)).astype(np.float32)
    return rng.integers(3, vocab_size, (batch, prompt_len)).astype(np.int32)


def _decode_input(tok: torch.Tensor, frontend_dim: int) -> torch.Tensor:
    """The next decode step's input: the tokens [B, 1], or with a frontend
    ``one_hot(tok, frontend_dim)`` [B, 1, F] in f32, a zero row for a token
    ≥ ``frontend_dim`` (as ``jax.nn.one_hot``)."""
    if not frontend_dim:
        return tok[:, None]
    ids = torch.arange(frontend_dim, device=tok.device)
    return (tok[:, None, None] == ids).to(torch.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params: Transformer, prompts, max_new: int, eos_id: int = 2,
             staleness: int = 4) -> Dict[str, Any]:
    """Prefill ``prompts`` (token ids [B, S], or embeddings [B, S, F] for a
    frontend model), then greedy-decode up to ``max_new`` tokens, stopping
    when the PFAIT monitor sees the K-stale indicator g = 1 − [all
    finished] under ε = 0.5.  A frontend model decodes from
    ``one_hot(token, F)``, as the JAX server feeds it.

    Returns the JAX ``serve`` dict — ``tokens`` [B, ≤ max_new] with the
    tokens past each sequence's first EOS drained to ``eos_id``,
    ``finished``, ``steps`` (decode steps run), ``stopped_by``
    ("detector" or "budget"), ``wall_s``, ``tok_per_s`` — plus the wall
    time of the prefill (``prefill_s``) and of the decode loop
    (``decode_s``), and ``logits_finite``: no NaN or inf in any logits of
    the run (a device-side flag read once, at the end).  The KV cache is
    allocated once at S + ``max_new`` and written in place.
    """
    dev = model.device
    frontend_dim = model.cfg.frontend_dim if model.cfg.frontend else 0
    prompts = torch.as_tensor(prompts)
    prompts = (prompts.float() if frontend_dim else prompts.long()).to(dev)
    batch, prompt_len = prompts.shape[:2]
    prefill = model.make_prefill()
    decode = model.make_decode_step()

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, max_len=prompt_len + max_new)
    tok = logits[:, -1].argmax(dim=-1)  # [B]
    finite = logits.isfinite().all()
    _sync(dev)
    t_prefill = time.perf_counter()
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    generated = [tok]
    # K-stale termination (PFAIT monitor): g = 1 − [all finished] ∈ {0, 1},
    # ε = 0.5, so the monitor fires when the flag launched K steps ago was
    # set — the loop never waits on the fresh flag
    mon = detection.MonitorConfig(mode="pfait", eps=0.5, staleness=staleness,
                                  ord=float("inf"))
    mstate = detection.init_state(mon, dev)
    steps_done = 0
    stopped_by = "budget"
    for i in range(max_new - 1):
        logits, cache = decode(params, cache, _decode_input(tok, frontend_dim),
                               prompt_len + i)
        tok = logits[:, -1].argmax(dim=-1)
        finite = finite & logits.isfinite().all()
        finished = finished | (tok == eos_id)
        generated.append(tok)
        g = 1.0 - finished.all().float()
        mstate = detection.step(mon, mstate, g)
        steps_done = i + 1
        if bool(detection.should_stop(mstate)):   # stale view only
            stopped_by = "detector"
            break
    toks = torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)
    # drain: mask the ≤ K tokens generated past each sequence's first EOS —
    # the stale detector deliberately over-runs, the report must not leak
    # the over-run tokens as real output
    eos_hits = toks == eos_id
    past_eos = np.cumsum(np.cumsum(eos_hits, axis=1), axis=1) > 1
    toks = np.where(past_eos, eos_id, toks)
    fin = finished.cpu().numpy()
    t_end = time.perf_counter()
    wall = t_end - t0
    return {
        "tokens": toks,
        "finished": fin,
        "steps": steps_done,
        "stopped_by": stopped_by,
        "wall_s": wall,
        "tok_per_s": batch * steps_done / max(wall, 1e-9),
        "prefill_s": t_prefill - t0,
        "decode_s": t_end - t_prefill,
        "logits_finite": bool(finite),
    }


def serve(
    arch: str,
    batch: int = 4,
    prompt_len: int = 32,
    max_new: int = 32,
    use_reduced: bool = True,
    eos_id: int = 2,
    staleness: int = 4,
    seed: int = 0,
    greedy: bool = True,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Batched prefill + decode of ``arch`` with seed-initialised weights,
    on the card unless ``device`` says otherwise; see ``generate`` for the
    loop and the returned dict.  Decoding is greedy (``greedy`` is kept for
    the JAX signature)."""
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduced_cfg(cfg)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    prompts = make_prompts(cfg.vocab_size, batch, prompt_len, seed,
                           cfg.frontend_dim if cfg.frontend else 0)
    return generate(model, params, prompts, max_new, eos_id=eos_id, staleness=staleness)


def _demo_service(device: DeviceLike = None) -> None:
    """Tiny mixed-tenant demo of the detection service (CLI)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(12):
        fam = ("convdiff", "pagerank", "mlfixed")[i % 3]
        problem = {
            "convdiff": {"n": 8, "p": 4, "rho": 0.9},
            "pagerank": {"n": 64, "p": 4},
            "mlfixed": {"n": 16, "p": 4, "m_rows": 48, "cond": 10.0},
        }[fam]
        spec = TenantSpec(
            tenant=f"t{i:02d}", family=fam, problem=problem,
            seed=int(rng.integers(0, 4)),
            eps_tilde=float(rng.choice([1e-4, 1e-5])),
            mode=str(rng.choice(["pfait", "nfais5"])),
            staleness=int(rng.integers(0, 5)))
        reqs.append((spec, int(rng.integers(0, 6))))
    rep = serve_detection(reqs, ServeConfig(lanes=4, chunk=16, max_steps=2048),
                          device=device)
    print(f"[serve] served={rep.served} rejected={rep.rejected} "
          f"false={rep.false_detections} compiles={rep.compile_count} "
          f"warm={rep.warm_hits} ticks={rep.ticks} "
          f"ttd={rep.ttd_ticks} wall={rep.wall_s:.2f}s")


def main() -> None:
    """CLI: LM decode serving, or the detection-service demo."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    # as in the JAX CLI: store_true with default True, so always reduced
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--detection-demo", action="store_true",
                    help="run the multi-tenant detection-service demo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.detection_demo:
        _demo_service(args.device)
        return
    if not args.arch:
        ap.error("--arch is required unless --detection-demo is given")
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, use_reduced=args.reduced, device=args.device)
    print(f"[serve] generated {out['tokens'].shape} in {out['wall_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s, stopped by {out['stopped_by']})")


if __name__ == "__main__":
    main()
