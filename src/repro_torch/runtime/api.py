"""Unified runtime API — one config, one report, three runtimes.

* ``RuntimeConfig`` — one frozen config carrying the union of the
  asynchrony knobs of the JAX package's ``RuntimeConfig`` (every field, so
  a JAX config maps across field by field), validated once and converted
  to the per-runtime configs by ``to_shard_config()`` /
  ``to_train_config()``.
* ``RunReport`` — the result: residual history, detection step, wall
  segments, schema trace (``core.trace``), membership log, solution, and
  the raw per-runtime result.
* ``run_shard`` / ``run_train`` — place the inputs on the device once
  (over a ``ShardGroup``, each rank its own block or rows), build the shard
  runtime of a problem family (``shard_runtime.make_runtime``) or the
  data-parallel training runtime (``train_async.make_train_runtime``) and
  run it; ``run_elastic`` runs the fault-injected elastic driver
  (``elastic.run_elastic``).  Trace recording attaches here
  (``record_trace=True``).
* ``TenantReport`` / ``ServeReport`` — what the multi-tenant detection
  service (``launch/serve.py``) reports, per tenant and for the service.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core.reduction import get_reduction
from repro_torch.core.trace import (
    Trace,
    _series_prefix,
    trace_from_elastic_report,
    trace_from_shard_run,
    trace_from_train_run,
)
from repro_torch.launch.mesh import ShardGroup, local_slices, place_blocks, shard_axis_names
from repro_torch.runtime import elastic as _elastic
from repro_torch.runtime.shard_runtime import ShardRuntimeConfig, make_runtime
from repro_torch.runtime.train_async import TrainAsyncConfig, make_train_runtime

#: trace_len used when ``record_trace=True`` and the user left trace_len=0
DEFAULT_TRACE_LEN = 512


@dataclass(frozen=True)
class RuntimeConfig:
    """The union of the runtimes' asynchrony knobs.

    Per-shard fields (``inner_sweeps``/``halo_delay``/``contrib_lag``)
    accept a scalar or a length-p sequence exactly like the shard config.
    ``axis`` names the shard axes of a ``launch.mesh.ShardGroup``
    (``shard_axis_names``: the axis itself on a 1-D mesh, ``axis_x``,
    ``axis_y``[, ``axis_z``] on more), as it names the JAX mesh's;
    ``run_shard`` and ``run_train`` hold a group to it.  Fields a runtime
    does not use are ignored by its converter (``num_batches``/``gamma``
    are training-only; ``sweep``, ``mesh_shape``, ``overlap`` convdiff-only).
    """

    monitor: detection.MonitorConfig
    reduction: str = "nonblocking"
    inner_sweeps: Union[int, Sequence[int]] = 1
    halo_delay: Union[int, Sequence[int]] = 0
    contrib_lag: Union[int, Sequence[int]] = 0
    max_outer: int = 10_000
    trace_len: int = 0
    axis: str = "shard"
    sweep: str = "jacobi"            # convdiff only
    mesh_shape: Optional[Tuple[int, ...]] = None  # convdiff only: (px[,py[,pz]])
    overlap: bool = False            # convdiff only: comm-overlapped exchange
    num_batches: int = 1             # training only
    gamma: Optional[float] = None    # training only
    record_trace: bool = False       # attach a schema Trace to the report

    def __post_init__(self):
        get_reduction(self.reduction)  # registry validation at construction
        if self.max_outer < 1:
            raise ValueError(f"max_outer={self.max_outer} must be >= 1")

    def _trace_len(self) -> int:
        if self.record_trace and not self.trace_len:
            return min(DEFAULT_TRACE_LEN, self.max_outer)
        return int(self.trace_len)

    def to_shard_config(self) -> ShardRuntimeConfig:
        """The equivalent ``ShardRuntimeConfig``."""
        return ShardRuntimeConfig(
            monitor=self.monitor, reduction=self.reduction,
            inner_sweeps=self.inner_sweeps, halo_delay=self.halo_delay,
            contrib_lag=self.contrib_lag, max_outer=self.max_outer,
            trace_len=self._trace_len(), sweep=self.sweep,
            mesh_shape=self.mesh_shape, overlap=self.overlap)

    def to_train_config(self) -> TrainAsyncConfig:
        """The equivalent ``TrainAsyncConfig`` (inner_sweeps→inner_steps,
        halo_delay→view_delay, max_outer→max_rounds)."""
        return TrainAsyncConfig(
            monitor=self.monitor, reduction=self.reduction,
            inner_steps=self.inner_sweeps, view_delay=self.halo_delay,
            contrib_lag=self.contrib_lag, num_batches=self.num_batches,
            gamma=self.gamma, max_rounds=self.max_outer,
            trace_len=self._trace_len())


@dataclass
class RunReport:
    """What the unified entry point returns."""

    converged: bool
    detected_residual: Optional[float]
    detect_step: Optional[int]           # outer step the claim fired at
    outer_iters: int
    residual_history: np.ndarray         # launched residuals (finite prefix)
    wall_segments: List[Tuple[str, float]]   # [(name, seconds)]
    trace: Optional[Trace]               # schema trace (record_trace=True)
    membership_log: List[Tuple[int, str, str]]   # (segment, kind, detail)
    x: Any                               # final solution (runtime's layout)
    raw: Any = field(repr=False, default=None)   # the per-runtime result

    @property
    def wall_s(self) -> float:
        """Total wall seconds across all measured run segments."""
        return float(sum(s for _, s in self.wall_segments))


@dataclass
class TenantReport:
    """Per-tenant outcome of one detection-service solve (``launch/serve.py``).

    ``status`` is the tenant's terminal state: ``"served"`` (detection
    fired), ``"timeout"`` (step budget exhausted without detection),
    ``"rejected"`` (failed admission validation — ``error``/``reason``
    carry the structured cause), or ``"shed"`` (still queued when the
    service shut down).  Tick fields are in service ticks (one tick = one
    ``chunk`` of device steps per lane bucket) and are deterministic for a
    seeded load; ``detect_step`` is the lane-local check index, bitwise
    comparable to a solo ``detection.batched_monitor`` run over
    ``series``, the raw (pre-σ, f32) contribution series the lane produced
    (None for a tenant that never ran).
    """

    tenant: str
    status: str
    family: str = ""
    mode: str = ""
    eps_tilde: float = float("nan")
    converged: bool = False
    detect_step: Optional[int] = None
    detected_residual: Optional[float] = None
    steps: int = 0                       # device steps executed
    arrival_tick: int = 0
    admit_tick: Optional[int] = None
    done_tick: Optional[int] = None
    queue_wait_ticks: Optional[int] = None
    ttd_ticks: Optional[int] = None      # time-to-detection, arrival → done
    oracle_step: Optional[int] = None    # first true crossing below ε̃
    false_detection: bool = False
    signature: str = ""                  # executable key (warm-sharing id)
    error: Optional[str] = None          # rejection code
    reason: Optional[str] = None         # rejection detail
    series: Optional[np.ndarray] = field(repr=False, default=None)


@dataclass
class ServeReport(RunReport):
    """Service-level ``RunReport`` of a multi-tenant detection campaign.

    The inherited fields take their service-level meaning: ``converged``
    is True iff every admitted tenant's detection fired (no timeouts),
    ``outer_iters`` counts service ticks, ``wall_segments`` holds the
    single ``("serve", seconds)`` segment (the ticks' wall time), and
    ``x``/``trace`` are unused.  ``queue_wait_ticks``/``ttd_ticks`` are
    nearest-rank p50/p95/p99 percentile dicts over served tenants.
    ``compile_count`` counts lane runners built, one per signature (on the
    card, one CUDA-graph capture each).  ``throughput`` holds tenants per
    tick and per second, ms per tick, and per family the lane-steps per
    second of its buckets' chunks, captures excluded
    (``"lane_steps_per_s/<family>"``).
    """

    tenants: List[TenantReport] = field(default_factory=list)
    served: int = 0
    rejected: int = 0
    shed: int = 0
    timeouts: int = 0
    false_detections: int = 0
    compile_count: int = 0               # distinct lane runners built
    warm_hits: int = 0                   # admissions served by a live runner
    ticks: int = 0
    queue_wait_ticks: Dict[str, float] = field(default_factory=dict)
    ttd_ticks: Dict[str, float] = field(default_factory=dict)
    throughput: Dict[str, float] = field(default_factory=dict)


def _history(trace_arr, outer: int, tlen: int) -> np.ndarray:
    arr = np.asarray(_series_prefix(trace_arr, min(outer, max(tlen, 1))))
    return arr[np.isfinite(arr)]


def _detect_step(converged: bool, outer: int) -> Optional[int]:
    return outer - 1 if converged and outer > 0 else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_shard(family: str, cfg: RuntimeConfig,
              p: Union[int, Tuple[int, ...], ShardGroup], n: int, x0, arg, *,
              stencil=None, damping: float = 0.85, timing_runs: int = 0,
              device: DeviceLike = None) -> RunReport:
    """Place, build and run the asynchronous shard solver; one call.

    ``p`` is a shard count or mesh shape (the stacked transport, on
    ``device``, default ``cuda``) or a ``ShardGroup`` (one shard per rank,
    on the group's device; its axes must be ``cfg.axis``'s).  ``x0``/``arg``
    (the rhs ``b`` for convdiff, the dense operator for pagerank) may be
    host arrays: they are placed once, whole on the stacked transport and
    as the rank's block (``launch.mesh.local_slices``) over a group.  Wall
    segments: ``build`` (placement, the runtime's construction and a first
    run, where the kernels load), ``run`` (a second run: the steady-state
    cost a trace records) and ``timing_runs`` further ``rerun`` runs, each
    between device synchronisations.
    """
    scfg = cfg.to_shard_config()
    group = _group_of(p, cfg)
    dev = group.device if group else resolve_device(device)
    n_shards = group.p if group else int(np.prod(p))
    # this process's part, placed once: the whole arrays, or the rank's block
    part = {0: local_slices(family, group, n) if group else ()}
    _sync(dev)
    t0 = time.perf_counter()
    (a_dev,) = place_blocks(arg, part, dev).values()
    (x_dev,) = place_blocks(x0, part, dev, a_dev.dtype).values()
    run = make_runtime(family, scfg, p, n, stencil=stencil, damping=damping,
                       device=dev)
    run(x_dev, a_dev)
    _sync(dev)
    t1 = time.perf_counter()
    result = run(x_dev, a_dev)
    _sync(dev)
    t2 = time.perf_counter()
    segments = [("build", t1 - t0), ("run", t2 - t1)]
    segments += _timed_reruns(run, (x_dev, a_dev), timing_runs, dev)
    return _shard_report(result, scfg, n_shards, segments, source="shard")


def run_train(problem, cfg: RuntimeConfig, p: Union[int, ShardGroup], X0, A, y, *,
              timing_runs: int = 0, device: DeviceLike = None) -> RunReport:
    """Place, build and run the asynchronous data-parallel training loop.

    ``p`` is a shard count (the replicas stacked on ``device``, default
    ``cuda``) or a 1-D ``ShardGroup`` (one replica per rank; its axis must
    be ``cfg.axis``).  ``X0`` [p, n], ``A`` [m, n] and ``y`` [m] may be host
    arrays: they are placed once, whole on the stacked transport and as the
    rank's replica and rows over a group.  Wall segments as ``run_shard``'s.
    """
    tcfg = cfg.to_train_config()
    group = _group_of(p, cfg)
    dev = group.device if group else resolve_device(device)
    n_shards = group.p if group else int(p)
    m, n = problem.m, problem.n
    if m % n_shards:
        raise ValueError(f"m_rows={m} not divisible by p={n_shards}")
    rows = m // n_shards
    r = group.rank if group else 0

    def part(lo, hi):
        """This process's part, placed once: the whole array, or the rank's
        own replica or rows."""
        return {0: (slice(lo, hi),) if group else ()}

    _sync(dev)
    t0 = time.perf_counter()
    (a_dev,) = place_blocks(A, part(r * rows, (r + 1) * rows), dev, gshape=(m, n),
                            what=f"A must be ({m}, {n})").values()
    (y_dev,) = place_blocks(y, part(r * rows, (r + 1) * rows), dev, a_dev.dtype,
                            gshape=(m,), what=f"y must be ({m},)").values()
    (x_dev,) = place_blocks(X0, part(r, r + 1), dev, a_dev.dtype, gshape=(n_shards, n),
                            what=f"X0 must be ({n_shards}, {n})").values()
    run = make_train_runtime(problem, tcfg, p, device=dev)
    run(x_dev, a_dev, y_dev)
    _sync(dev)
    t1 = time.perf_counter()
    result = run(x_dev, a_dev, y_dev)
    _sync(dev)
    t2 = time.perf_counter()
    segments = [("build", t1 - t0), ("run", t2 - t1)]
    segments += _timed_reruns(run, (x_dev, a_dev, y_dev), timing_runs, dev)
    return _shard_report(result, tcfg, n_shards, segments, source="train")


def run_elastic(family: str, cfg: RuntimeConfig, n: int, x0, arg, plan,
                ckpt_dir: str, **knobs) -> RunReport:
    """The elastic fault-injected driver through the unified surface.

    ``knobs`` pass through to ``elastic.run_elastic`` (``slots``, ``p0``,
    ``segment_len``, ``ckpt_every``, ``heartbeat_timeout``,
    ``max_segments``, ``straggler_policy``, ``keep``, ``stencil``,
    ``damping``, ``device``).  ``cfg.max_outer`` is owned by the driver's
    segmentation.  The one wall segment is the whole driver (``elastic``);
    the report's ``raw`` (an ``ElasticReport``) holds the segments' walls.
    """
    scfg = cfg.to_shard_config()
    t0 = time.perf_counter()
    report = _elastic.run_elastic(family, scfg, n, x0, arg, plan, ckpt_dir, **knobs)
    t1 = time.perf_counter()
    p0 = report.mesh_history[0][1] if report.mesh_history else 1
    tr = None
    if cfg.record_trace:
        tr = trace_from_elastic_report(report, scfg, p0)
        tr.validate()
    return RunReport(
        converged=bool(report.converged),
        detected_residual=report.detected_residual,
        detect_step=(report.outer_iters - 1 if report.converged else None),
        outer_iters=int(report.outer_iters),
        residual_history=np.asarray(
            [] if report.detected_residual is None
            else [report.detected_residual], dtype=np.float64),
        wall_segments=[("elastic", t1 - t0)],
        trace=tr,
        membership_log=list(report.events),
        x=report.x,
        raw=report,
    )


def _group_of(p, cfg: RuntimeConfig) -> Optional[ShardGroup]:
    """``p`` if it is a ``ShardGroup`` (held to ``cfg.axis``), else None."""
    if not isinstance(p, ShardGroup):
        return None
    if p.axis_names != shard_axis_names(cfg.axis, len(p.shape)):
        raise ValueError(f"the group's axes {p.axis_names} are not those of "
                         f"cfg.axis {cfg.axis!r}")
    return p


def _timed_reruns(run, args, timing_runs: int,
                  dev: torch.device) -> List[Tuple[str, float]]:
    out = []
    for _ in range(max(int(timing_runs), 0)):
        t0 = time.perf_counter()
        run(*args)
        _sync(dev)
        out.append(("rerun", time.perf_counter() - t0))
    return out


def _shard_report(result, rcfg, p: int, segments, source: str) -> RunReport:
    outer = int(getattr(result, "outer_iters", getattr(result, "rounds", 0)))
    converged = bool(result.converged)
    # the trace's wall is the steady-state run, not the first (kernel
    # loading) one: cost calibration must see what a long run pays per step
    wall = float(dict(segments)["run"])
    tr = None
    if rcfg.trace_len > 0:
        adapter = trace_from_train_run if source == "train" else trace_from_shard_run
        tr = adapter(result, rcfg, p, wall)
        tr.validate()
    return RunReport(
        converged=converged,
        detected_residual=float(result.residual) if converged else None,
        detect_step=_detect_step(converged, outer),
        outer_iters=outer,
        residual_history=_history(result.trace, outer, rcfg.trace_len),
        wall_segments=list(segments),
        trace=tr,
        membership_log=[],
        x=result.x,
        raw=result,
    )
