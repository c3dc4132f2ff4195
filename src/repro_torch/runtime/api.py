"""Unified runtime API — one config, one report, one shard entry point.

* ``RuntimeConfig`` — one frozen config carrying the union of the
  asynchrony knobs of the JAX package's ``RuntimeConfig`` (every field, so
  a JAX config maps across field by field), validated once and converted
  to the shard runtime's config by ``to_shard_config()``.
* ``RunReport`` — the result: residual history, detection step, wall
  segments, schema trace (``core.trace``), solution, and the raw
  ``ShardRunResult``.
* ``run_shard`` — places the inputs on the device once (over a
  ``ShardGroup``, each rank its own block), builds the shard runtime of a
  problem family (``shard_runtime.make_runtime``) and runs it.
  Trace recording attaches here (``record_trace=True``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core.reduction import get_reduction
from repro_torch.core.trace import Trace, _series_prefix, trace_from_shard_run
from repro_torch.launch.mesh import ShardGroup, local_slices, place_blocks, shard_axis_names
from repro_torch.runtime.shard_runtime import ShardRuntimeConfig, make_runtime

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
    ``run_shard`` holds a group to it.  ``num_batches``/``gamma`` are
    training-only, and the shard runtime's converter ignores them.
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
    x: Any                               # final solution (global layout)
    raw: Any = field(repr=False, default=None)   # the ShardRunResult

    @property
    def wall_s(self) -> float:
        """Total wall seconds across all measured run segments."""
        return float(sum(s for _, s in self.wall_segments))


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
    group = p if isinstance(p, ShardGroup) else None
    if group is not None and group.axis_names != shard_axis_names(cfg.axis,
                                                                  len(group.shape)):
        raise ValueError(f"the group's axes {group.axis_names} are not those of "
                         f"cfg.axis {cfg.axis!r}")
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
    return _shard_report(result, scfg, n_shards, segments)


def _timed_reruns(run, args, timing_runs: int,
                  dev: torch.device) -> List[Tuple[str, float]]:
    out = []
    for _ in range(max(int(timing_runs), 0)):
        t0 = time.perf_counter()
        run(*args)
        _sync(dev)
        out.append(("rerun", time.perf_counter() - t0))
    return out


def _shard_report(result, scfg: ShardRuntimeConfig, p: int, segments) -> RunReport:
    outer = int(result.outer_iters)
    converged = bool(result.converged)
    # the trace's wall is the steady-state run, not the first (kernel
    # loading) one: cost calibration must see what a long run pays per step
    wall = float(dict(segments)["run"])
    tr = None
    if scfg.trace_len > 0:
        tr = trace_from_shard_run(result, scfg, p, wall)
        tr.validate()
    return RunReport(
        converged=converged,
        detected_residual=float(result.residual) if converged else None,
        detect_step=_detect_step(converged, outer),
        outer_iters=outer,
        residual_history=_history(result.trace, outer, scfg.trace_len),
        wall_segments=list(segments),
        trace=tr,
        membership_log=[],
        x=result.x,
        raw=result,
    )
