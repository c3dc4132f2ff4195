"""Trace-driven replay — re-execute a recorded run under modified
assumptions and predict what a measurement cannot reach (the port's copy
of the JAX package's ``sim/replay.py``; pure numpy).

A recorded ``core.trace`` pins down everything the replayer needs: the
per-worker asynchrony knobs (inner sweeps, halo delay, contribution lag),
the reduction mode and its topology facts (``core.reduction``), the
effective detection-monitor parameters, and the launched global-residual
series.  Replay then runs two deterministic models over it:

* **Detection replay** — a numpy mirror of ``core.detection``'s monitor
  update (the ``_lane_step`` semantics: ring of K+1 in-flight reductions,
  visible value = the one launched K checks ago) consuming the recorded
  residual series under the *target* topology's staleness structure.  On a
  self-replay (same topology, same K) the predicted detection step is
  exact by construction — the device trace records precisely the series
  the device monitor consumed.
* **Wall-clock replay** — a per-worker partial-order virtual clock:
  worker w's step k starts when its own step k-1 and its neighbours'
  steps k-delay[w]-1 (the halo it consumes) have finished, pays
  ``inner[w] · sweep_cost · straggler[w]`` of compute, and then the
  topology's synchronisation cost (nothing for flat non-blocking, an
  XOR-partner pairwise sync per butterfly round, a full barrier +
  2·ceil(log2 p) hops for flat blocking / tree).  Wall time is the
  last worker's clock at the predicted detection step.

What-if knobs (``WhatIf``): scale the shard count (per-shard compute
scales by p_ref/p — the cells-per-shard model), swap the reduction
topology (``flat-nonblocking`` / ``flat-blocking`` / ``butterfly`` /
``tree``), inject stragglers.  Everything is pure numpy and RNG-free:
the same trace and the same what-if always produce the identical verdict.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.trace import Trace

#: replayable reduction topologies (what-if targets)
TOPOLOGIES = ("flat-nonblocking", "flat-blocking", "butterfly", "tree")

_MODE_TOPOLOGY = {
    "nonblocking": "flat-nonblocking",
    "blocking": "flat-blocking",
    "rdoubling": "butterfly",
}


@dataclass(frozen=True)
class CostModel:
    """Per-shard cost constants the virtual clock runs on.

    ``sweep_s`` is the compute cost of ONE inner sweep on one shard at the
    reference shard count ``p_ref``; scaling to p shards multiplies by
    ``p_ref / p`` (each shard owns proportionally fewer cells).  ``hop_s``
    is one message hop; ``residual_pass_s`` the blocking mode's extra
    residual-only pass (detection work on the critical path).

    ``sweep_s_per_worker`` (optional) carries heterogeneous per-worker
    sweep costs at ``p_ref`` — fitted by ``sim.calibrate.fit_cost_model``
    from per-worker sweep-event gaps when the trace resolves them (engine
    traces; device traces interpolate uniformly and carry no skew).  Its
    mean is ``sweep_s`` by construction, so scalar consumers are unchanged;
    the virtual clock uses the per-worker vector whenever the replayed
    shard count matches its length.
    """

    sweep_s: float
    hop_s: float
    residual_pass_s: float
    p_ref: int
    sweep_s_per_worker: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.sweep_s < 0 or self.hop_s < 0 or self.residual_pass_s < 0:
            raise ValueError("cost-model constants must be >= 0")
        if self.p_ref < 1:
            raise ValueError(f"p_ref={self.p_ref} must be >= 1")
        if self.sweep_s_per_worker is not None:
            spw = tuple(float(v) for v in self.sweep_s_per_worker)
            if not spw or any(v < 0 for v in spw):
                raise ValueError("sweep_s_per_worker must be non-empty "
                                 "with entries >= 0")
            object.__setattr__(self, "sweep_s_per_worker", spw)

    def sweep_at(self, p: int) -> float:
        return self.sweep_s * self.p_ref / max(int(p), 1)

    def sweep_vec_at(self, p: int) -> Optional[np.ndarray]:
        """Per-worker sweep costs at shard count p, or None when the model
        is uniform or the worker count no longer matches the fit."""
        if self.sweep_s_per_worker is None or len(
                self.sweep_s_per_worker) != int(p):
            return None
        return (np.asarray(self.sweep_s_per_worker, dtype=np.float64)
                * self.p_ref / max(int(p), 1))

    def residual_pass_at(self, p: int) -> float:
        return self.residual_pass_s * self.p_ref / max(int(p), 1)


@dataclass(frozen=True)
class WhatIf:
    """Modified assumptions to replay a trace under (all optional)."""

    p: Optional[int] = None                 # target shard count
    topology: Optional[str] = None          # TOPOLOGIES member
    stragglers: Mapping[int, float] = field(default_factory=dict)
    hop_s: Optional[float] = None           # override the cost model's hop

    def __post_init__(self):
        if self.topology is not None and self.topology not in TOPOLOGIES:
            raise ValueError(
                f"topology {self.topology!r} not in {TOPOLOGIES}")
        if self.p is not None and self.p < 1:
            raise ValueError(f"what-if p={self.p} must be >= 1")
        for w, f in self.stragglers.items():
            if f <= 0:
                raise ValueError(f"straggler factor {f} for worker {w} "
                                 "must be > 0")


@dataclass
class ReplayVerdict:
    """What the replayer predicts for one (trace, what-if) pair."""

    p: int
    topology: str
    converged: bool
    predicted_detect_step: Optional[int]   # outer step the claim fires at
    predicted_outer_iters: int
    predicted_wall_s: float
    staleness_steps: Optional[int]         # age of the detected value
    detected_residual: Optional[float]     # the (stale) value that fired
    fresh_residual: Optional[float]        # launched value at the same step
    approximate: bool                      # lossy topology conversion


# ---------------------------------------------------------------------------
# Detection replay (numpy mirror of core.detection's monitor update)
# ---------------------------------------------------------------------------


def visible_series(series: np.ndarray, topology: str, K: int,
                   p: int) -> np.ndarray:
    """What the monitor sees at each step, per topology.

    * flat topologies: the value launched K checks ago (the ring of K+1
      in-flight reductions; blocking forces K=0 upstream).
    * butterfly: a global value completes every R = log2(p) rounds and is
      sampled at its epoch's first round — visible at step k is the value
      launched at step R·floor((k+1)/R) − R, +inf before the first epoch
      completes (mirrors ``shard_runtime._butterfly_step``).
    """
    n = len(series)
    out = np.full(n, np.inf)
    if topology == "butterfly":
        R = max(p.bit_length() - 1, 1) if p > 1 else 1
        if p > 1 and p & (p - 1):
            raise ValueError(f"butterfly needs a power-of-two p, got {p}")
        for k in range(n):
            if p == 1:
                out[k] = series[k]
                continue
            if k >= R - 1:
                out[k] = series[R * ((k + 1) // R) - R]
        return out
    if K == 0:
        return np.asarray(series, dtype=np.float64).copy()
    out[K:] = series[:n - K]
    return out


def replay_monitor(series: np.ndarray, mode: str, eps: float,
                   eps_tilde: float, K: int, persistence: int,
                   topology: str = "flat-nonblocking", p: int = 1):
    """Replay the detection monitor over a launched-residual series.

    Numpy mirror of ``core.detection._lane_step`` (NFAIS2 uses the
    verifier-free fallback — a host replay cannot re-run the blocking
    verification).  Returns ``(detect_step | None, detected, fresh)``.
    """
    vis = visible_series(np.asarray(series, dtype=np.float64), topology,
                         int(K), int(p))
    m = int(persistence)
    persist = 0
    phase = 0
    confirm_at = None
    for k, v in enumerate(vis):
        below = v < eps
        if mode in ("sync", "pfait"):
            if below:
                return k, float(v), float(series[k])
            continue
        persist = persist + 1 if below else 0
        if mode == "nfais2":
            if persist >= m:                      # candidate fires
                if v < eps_tilde:                 # fallback acceptance
                    return k, float(v), float(series[k])
                persist = 0
            continue
        # nfais5 — two-phase persistence confirmation
        confirming = phase == 1 and confirm_at is not None and k >= confirm_at
        if confirming:
            if below and persist >= 2 * m:
                return k, float(v), float(series[k])
            phase, confirm_at = 0, None
        if persist >= m and phase == 0:
            phase, confirm_at = 1, k + m
    return None, None, None


# ---------------------------------------------------------------------------
# Wall-clock replay (per-worker partial-order virtual clock)
# ---------------------------------------------------------------------------


def predict_wall(steps: int, p: int, inner: np.ndarray, delay: np.ndarray,
                 straggler: np.ndarray, cost: CostModel, topology: str,
                 hop_s: Optional[float] = None) -> float:
    """Virtual-clock wall time of ``steps`` outer steps on ``p`` workers.

    Per-step structural model (``sim.calibrate.fit_cost_model`` inverts
    exactly this shape on uniform traces, so the constants round-trip):
    worker w's step k starts once its own step k-1 and the neighbour halos
    it consumes (published at step k-delay[w]-1, one hop old) are in; it
    pays ``inner[w]·sweep·straggler[w]`` of compute; the topology then adds
    its synchronisation — nothing (flat non-blocking), an XOR-partner
    pairwise sync + hop (butterfly round k mod log2 p), or a full barrier
    plus 2·ceil(log2 p) hops of allreduce (flat blocking, which also pays
    the extra residual-only pass / tree, which does not).
    """
    if steps <= 0:
        return 0.0
    hop = float(cost.hop_s if hop_s is None else hop_s)
    sweep_vec = cost.sweep_vec_at(p)
    sweep = sweep_vec if sweep_vec is not None else cost.sweep_at(p)
    comp = inner.astype(np.float64) * sweep * straggler.astype(np.float64)
    allreduce = 2.0 * math.ceil(math.log2(p)) * hop if p > 1 else 0.0
    R = max(p.bit_length() - 1, 1) if p > 1 else 1
    idx = np.arange(p)
    H = int(delay.max()) + 2       # history window the halo deps can reach
    hist = np.zeros((H, p))        # hist[k % H] = finish time of step k
    t = np.zeros(p)
    for k in range(steps):
        start = t.copy()
        if p > 1:
            dep = k - delay - 1    # halo published at step k - delay - 1
            row = np.mod(dep, H)
            left = np.where(idx > 0,
                            hist[row, np.maximum(idx - 1, 0)], -np.inf)
            right = np.where(idx < p - 1,
                             hist[row, np.minimum(idx + 1, p - 1)], -np.inf)
            nbr = np.where(dep >= 0, np.maximum(left, right) + hop, -np.inf)
            start = np.maximum(start, nbr)
        fin = start + comp
        if topology == "flat-blocking":
            fin = np.full(p, fin.max() + cost.residual_pass_at(p) + allreduce)
        elif topology == "tree":
            fin = np.full(p, fin.max() + allreduce)
        elif topology == "butterfly" and p > 1:
            partner = idx ^ (1 << (k % R))
            fin = np.maximum(fin, fin[partner]) + hop
        # flat-nonblocking: the collective stays off the critical path
        hist[k % H] = fin
        t = fin
    return float(t.max())


# ---------------------------------------------------------------------------
# Trace parsing + the replay entrypoint
# ---------------------------------------------------------------------------


def _per_worker(meta_val, p: int) -> np.ndarray:
    arr = np.asarray(meta_val if meta_val is not None else 1)
    if arr.ndim == 0:
        return np.full(p, float(arr))
    if len(arr) == p:
        return arr.astype(np.float64)
    # shard-count change: broadcast the mean knob
    return np.full(p, float(arr.mean()))


def replay(trace: Trace, cost: CostModel,
           what_if: Optional[WhatIf] = None) -> ReplayVerdict:
    """Re-execute a recorded trace under modified assumptions.

    Deterministic: the same ``(trace, cost, what_if)`` triple always
    produces an identical verdict.  The recorded residual series is held
    invariant under shard-count scaling (the fixed-point contraction is a
    problem property, not a topology property) — the knobs that *do* move
    the detection step are the topology's staleness structure and the
    monitor's pipeline depth, both replayed exactly.

    Topology conversions from a butterfly-recorded trace are flagged
    ``approximate``: its series already carries the log2(p) pipeline
    staleness, which a host replay cannot un-bake.
    """
    wi = what_if or WhatIf()
    meta = trace.meta
    p0 = trace.p
    p = int(wi.p if wi.p is not None else p0)
    src_topology = meta.get("topology")
    if src_topology is None:
        src_topology = _MODE_TOPOLOGY.get(meta.get("reduction", ""), "flat")
    if src_topology == "flat":
        src_topology = _MODE_TOPOLOGY[meta.get("reduction", "nonblocking")]
    topology = wi.topology or src_topology
    # a butterfly-recorded series already carries its pipeline staleness:
    # re-applying butterfly (or flattening) double/under-counts it, so the
    # self-replay consumes it flat and conversions are flagged approximate
    src_butterfly = src_topology == "butterfly"
    consume_topology = topology
    approximate = False
    if src_butterfly:
        if topology == src_topology and p == p0:
            consume_topology = "flat-nonblocking"   # staleness already baked
        else:
            approximate = True
    mon = dict(meta.get("monitor") or {})
    mode = mon.get("mode", "pfait")
    if mode == "nfais2":
        approximate = True   # verifier-free fallback semantics
    series = np.asarray(trace.residual_series(), dtype=np.float64)
    if series.size == 0:
        raise ValueError("trace carries no reduce-event residual series "
                         "(record with trace_len > 0 / record_trace=True)")
    K = int(mon.get("staleness", 0))
    if topology in ("flat-blocking", "tree", "butterfly"):
        K = 0   # barrier / pipelined topologies consume immediately
    detect_step, detected, fresh = replay_monitor(
        series, mode, float(mon.get("eps", 1e-6)),
        float(mon.get("eps_tilde", mon.get("eps", 1e-6))), K,
        int(mon.get("persistence", 4)), consume_topology, p)
    converged = detect_step is not None
    outer = detect_step + 1 if converged else len(series)

    inner = _per_worker(meta.get("inner_sweeps"), p)
    delay = _per_worker(meta.get("halo_delay"), p).astype(np.int64)
    straggler = np.ones(p)
    for w, f in wi.stragglers.items():
        if 0 <= int(w) < p:
            straggler[int(w)] = float(f)
    wall = predict_wall(outer, p, inner, delay, straggler, cost, topology,
                        hop_s=wi.hop_s)

    staleness_steps = None
    if converged:
        if consume_topology == "butterfly" and p > 1:
            R = max(p.bit_length() - 1, 1)
            staleness_steps = detect_step - (R * ((detect_step + 1) // R) - R)
        else:
            staleness_steps = K
    return ReplayVerdict(
        p=p, topology=topology, converged=converged,
        predicted_detect_step=detect_step, predicted_outer_iters=outer,
        predicted_wall_s=wall, staleness_steps=staleness_steps,
        detected_residual=detected, fresh_residual=fresh,
        approximate=approximate,
    )


def what_if_table(trace: Trace, cost: CostModel, shard_counts,
                  topologies=TOPOLOGIES) -> List[Dict]:
    """The extrapolation grid: one verdict row per (p, topology)."""
    rows = []
    for p in shard_counts:
        for topo in topologies:
            if topo == "butterfly" and int(p) & (int(p) - 1):
                continue
            v = replay(trace, cost, WhatIf(p=int(p), topology=topo))
            rows.append({
                "p": v.p, "topology": v.topology,
                "predicted_wall_s": v.predicted_wall_s,
                "predicted_detect_step": v.predicted_detect_step,
                "staleness_steps": v.staleness_steps,
                "approximate": v.approximate,
            })
    return rows
