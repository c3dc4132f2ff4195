"""Elastic shard counts + the fault-injected shard-runtime driver.

Two layers:

* **Shard-count surgery** (``remesh`` / ``validate_specs`` / ``reshard``):
  the largest (data, model) shape that fits a number of workers, a check
  that every sharded dimension still divides on it, and the placement of
  host (or checkpointed) arrays on the device.  A checkpoint holds host
  arrays (``checkpoint/checkpointer.py``) and no layout, so a shard count
  can change between save and restore.

* **Elastic control loop** (``run_elastic``): the crash → detect → restart
  → resume cycle for the asynchronous shard runtime
  (``runtime/shard_runtime.py``, stacked transport).  The solve is split
  into fixed-length *segments* (one virtual time unit each); between
  segments the control plane runs the fault-tolerance policies live:

    1. every alive shard heartbeats (``HeartbeatMonitor``) and reports its
       segment duration (``StragglerPolicy``) — a shard killed by the
       ``FaultPlan`` stops beating, and because the collective cannot
       complete without it, the *whole job stalls* (no iterations happen)
       until the failure is detected;
    2. once the heartbeat timeout elapses, ``plan_restart`` drops the dead
       shards, ``shrink_to_fit`` picks the largest usable shard count, and
       the last committed checkpoint is restored onto the device for the
       shrunk count — rolling back to the checkpointed outer iteration;
    3. the runtime of the new shard count runs on with the **unchanged
       detection monitor**.  Late joiners scale the shard count back up
       from *live* state (no rollback, nothing to restore).

This is the port of the JAX package's ``runtime/elastic.py``, event for
event.  The JAX driver caps the shard count at its device count; here the
stacked transport holds every shard on one device, and the cap is the
``slots`` argument.  The runtime of each shard count is built once and
kept; the state stays on the device between segments.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten, _unflatten
from repro_torch.core.reduction import get_reduction
from repro_torch.launch.mesh import place_blocks
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor,
    StragglerPolicy,
    plan_restart,
)
from repro_torch.runtime.shard_runtime import make_runtime


def remesh(n_devices: int, model_axis: int) -> Dict[str, int]:
    """Largest (data, model) shape that fits ``n_devices`` workers, as an
    axis-name → size mapping (a JAX mesh's ``shape``)."""
    data = max(n_devices // model_axis, 1)
    model = model_axis if n_devices >= model_axis else n_devices
    return {"data": data, "model": model}


def _is_shape(s) -> bool:
    return isinstance(s, (tuple, torch.Size)) and all(
        isinstance(d, (int, np.integer)) for d in s)


def validate_specs(shapes: Any, specs: Any, mesh: Mapping[str, int]) -> bool:
    """Whether every sharded dimension divides on ``mesh``.

    ``shapes`` is a tree (dicts, lists) of shape tuples and ``specs`` the
    same tree of partition specs: per leaf a tuple naming, for each
    dimension, a mesh axis, a tuple of axes or None (not sharded); missing
    trailing entries are None, and a leaf spec of None shards nothing."""
    if _is_shape(shapes):
        if specs is None:
            return True
        entries = tuple(specs) + (None,) * (len(shapes) - len(specs))
        for dim, names in zip(shapes, entries):
            if names is None:
                continue
            names_t = names if isinstance(names, tuple) else (names,)
            if dim % math.prod(mesh[name] for name in names_t):
                return False
        return True
    if isinstance(shapes, dict):
        return all(validate_specs(shapes[k], specs[k], mesh) for k in shapes)
    return all(validate_specs(s, sp, mesh) for s, sp in zip(shapes, specs))


def reshard(tree: Any, specs: Any, mesh: Mapping[str, int],
            device: DeviceLike = None) -> Any:
    """Place the host (or other-device) arrays of ``tree`` on ``device``
    (default ``cuda``) for ``mesh``: the stacked transport keeps every
    shard on that one device, so each leaf moves once, whole
    (``launch.mesh.place_blocks``).  Raises if a sharded dimension does not
    divide on ``mesh``."""
    leaves, spec = _flatten(tree)
    shapes = _unflatten(spec, [tuple(np.shape(leaf)) for leaf in leaves])
    if not validate_specs(shapes, specs, mesh):
        raise ValueError(f"a sharded dimension does not divide on mesh {dict(mesh)}")
    dev = resolve_device(device)
    return _unflatten(spec, [place_blocks(leaf, {0: ()}, dev)[0] for leaf in leaves])


# ---------------------------------------------------------------------------
# Elastic shard-runtime control loop
# ---------------------------------------------------------------------------


def shrink_to_fit(n: int, survivors: int, reduction: str = "nonblocking") -> int:
    """Largest shard count ≤ ``survivors`` the runtime can actually use:
    it must divide the block dimension ``n``, and the reduction mode's
    topology facts (``core.reduction``) must admit it — recursive doubling
    needs a power-of-two butterfly."""
    mode = get_reduction(reduction)   # validates the name too
    if survivors < 1:
        raise ValueError("no survivors to fit a mesh to")
    for p in range(min(int(survivors), int(n)), 0, -1):
        if n % p:
            continue
        if not mode.usable_shard_count(p):
            continue
        return p
    raise ValueError(f"no usable shard count for n={n}, "
                     f"survivors={survivors}, reduction={reduction!r}")


@dataclass(frozen=True)
class FaultPlan:
    """Deterministic fault schedule, in segment indices (virtual time).

    ``crash_at[w] = s``  — worker w dies *during* segment s: the segment's
                           collective never completes (its work is lost)
                           and w never heartbeats again.
    ``join_at[w] = s``   — standby worker w becomes available at the end of
                           segment s (hot scale-up from live state).
    ``slow[w] = f``      — worker w's reported segment duration is scaled
                           by f (feeds the straggler policy; a control-plane
                           signal only).
    """

    crash_at: Mapping[int, int] = field(default_factory=dict)
    join_at: Mapping[int, int] = field(default_factory=dict)
    slow: Mapping[int, float] = field(default_factory=dict)

    def __post_init__(self):
        for w, s in {**self.crash_at, **self.join_at}.items():
            if w < 0 or s < 0:
                raise ValueError(f"fault plan entry ({w}: {s}) must be >= 0")
        both = set(self.crash_at) & set(self.join_at)
        for w in both:
            if self.join_at[w] <= self.crash_at[w]:
                raise ValueError(
                    f"worker {w} rejoins at segment {self.join_at[w]} but "
                    f"only crashes at {self.crash_at[w]} — repair must "
                    "follow the crash")


@dataclass
class ElasticReport:
    """Outcome + recovery accounting of one elastic run.  The fields up to
    ``events`` are the JAX package's; the walls after them are measured
    here (host seconds, device synchronised)."""

    converged: bool
    detected_residual: Optional[float]
    outer_iters: int              # surviving outer iterations at the end
    segments_run: int
    restarts: int
    stall_segments: int           # segments lost to undetected-crash stalls
    lost_iters: int               # iterations rolled back to checkpoints
    detect_latency: List[float]   # segments from each crash to its detection
    checkpoint_saves: int
    mesh_history: List[Tuple[int, int]]   # (segment, shard count) changes
    stragglers_flagged: List[int]
    members_final: Tuple[int, ...]
    x: torch.Tensor               # final global solution (on the run's device)
    events: List[Tuple[int, str, str]] = field(default_factory=list)
    segment_walls: List[float] = field(default_factory=list)  # each run segment
    save_s: float = 0.0           # in ``save``: the host snapshots
    flush_s: float = 0.0          # waiting for background writes
    restore_s: float = 0.0        # restoring checkpoints onto the device


def run_elastic(
    family: str,
    cfg,                       # ShardRuntimeConfig (scalar per-shard fields)
    n: int,
    x0,
    arg,                       # convdiff: rhs b | pagerank: dense operator
    plan: FaultPlan,
    ckpt_dir: str,
    *,
    stencil=None,
    damping: float = 0.85,
    slots: Optional[int] = None,
    p0: Optional[int] = None,
    segment_len: int = 40,
    ckpt_every: int = 2,
    heartbeat_timeout: float = 2.2,
    max_segments: int = 80,
    straggler_policy=None,
    keep: int = 3,
    device: DeviceLike = None,
) -> ElasticReport:
    """Run the asynchronous shard runtime to convergence through the fault
    plan, on ``device`` (default ``cuda``).

    See the module docstring for the control-loop semantics; notable
    contracts:

    * ``slots`` caps the shard count (the JAX driver's device count) and
      ``p0``, the initial shard count, defaults to it; a worker that joins
      beyond the cap stays a spare of the control plane;
    * per-shard config fields must be scalars (the shard count changes
      mid-run, so a length-p sequence cannot follow it);
    * ``cfg.max_outer`` is ignored — the driver owns segmentation
      (``segment_len`` outers per segment, ``max_segments`` budget);
    * the detection monitor config is reused unchanged across restarts
      (its state re-initialises in each segment's run — the in-flight
      reductions of a dead collective are not salvageable, but the
      *policy* that decides termination never changes);
    * a committed checkpoint of the initial state is written synchronously
      before the first segment, so recovery is always possible.
    """
    for name in ("inner_sweeps", "halo_delay", "contrib_lag"):
        if not np.isscalar(getattr(cfg, name)):
            raise ValueError(
                f"elastic runs need scalar {name} (shard count changes)")
    if slots is None and p0 is None:
        raise ValueError("pass slots= (the shard-count cap) or p0=")
    slots = int(slots if slots is not None else p0)
    p0 = int(p0 if p0 is not None else slots)
    if shrink_to_fit(n, p0, cfg.reduction) != p0:
        raise ValueError(f"initial shard count p0={p0} unusable for n={n}, "
                         f"reduction={cfg.reduction!r}")
    dev = resolve_device(device)
    arg_dev = place_blocks(arg, {0: ()}, dev)[0]
    x_dev = place_blocks(x0, {0: ()}, dev, arg_dev.dtype)[0]

    ck = Checkpointer(ckpt_dir, keep=keep)
    hb = HeartbeatMonitor(timeout=float(heartbeat_timeout))
    strag = straggler_policy or StragglerPolicy()
    members: Tuple[int, ...] = tuple(range(p0))
    hb.register(members, 0.0)
    dead: set = set()
    flagged: set = set()
    report = ElasticReport(
        converged=False, detected_residual=None, outer_iters=0,
        segments_run=0, restarts=0, stall_segments=0, lost_iters=0,
        detect_latency=[], checkpoint_saves=0, mesh_history=[],
        stragglers_flagged=[], members_final=members, x=x_dev)
    crash_seen: Dict[int, int] = {}     # worker -> segment its crash landed

    cfg_seg = dataclasses.replace(cfg, max_outer=int(segment_len))
    built: Dict[int, Callable] = {}

    def build(p_cur: int, seg: int) -> Callable:
        """The runtime for ``p_cur`` shards (built once per count)."""
        if p_cur not in built:
            built[p_cur] = make_runtime(family, cfg_seg, p_cur, n, stencil=stencil,
                                        damping=damping, device=dev)
        report.mesh_history.append((seg, p_cur))
        return built[p_cur]

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save(blocking: bool = False) -> None:
        t0 = time.perf_counter()
        ck.save(x_dev, step=outer_done, blocking=blocking)
        report.save_s += time.perf_counter() - t0
        report.checkpoint_saves += 1

    def flush() -> None:
        t0 = time.perf_counter()
        ck.wait()                     # flush (and surface) async saves
        report.flush_s += time.perf_counter() - t0

    p_cur = p0
    run = build(p_cur, 0)
    outer_done = 0
    save(blocking=True)   # recovery floor

    for seg in range(int(max_segments)):
        report.segments_run = seg + 1
        t_end = float(seg + 1)
        for w in members:
            if w not in dead and plan.crash_at.get(w) == seg:
                dead.add(w)
                crash_seen[w] = seg
                report.events.append((seg, "crash", f"worker {w}"))
        stalled = any(w in dead for w in members[:p_cur])
        if not stalled:
            sync()
            t0 = time.perf_counter()
            r = run(x_dev, arg_dev)
            sync()
            report.segment_walls.append(time.perf_counter() - t0)
            x_dev = r.x
            outer_done += int(r.outer_iters)
            if bool(r.converged):
                report.converged = True
                report.detected_residual = float(r.residual)
                report.events.append((seg, "detect", f"g={float(r.residual):.3e}"))
                break
        else:
            report.stall_segments += 1
        # -- live control plane: heartbeats + straggler quantiles ----------
        for w in members:
            if w not in dead:
                hb.beat(w, t_end)
                strag.record(w, float(plan.slow.get(w, 1.0)))
        flagged.update(strag.check())
        failed = [w for w in hb.failed(t_end) if w in members]
        if failed:
            flush()
            step = ck.latest_step() or 0
            rplan = plan_restart(step, workers=members, failed=failed,
                                 model_axis=1)
            members = rplan.surviving_workers
            report.lost_iters += max(outer_done - step, 0)
            for w in failed:
                report.detect_latency.append(
                    t_end - float(crash_seen.get(w, seg)))
            outer_done = step
            p_cur = shrink_to_fit(n, min(len(members), slots), cfg.reduction)
            t0 = time.perf_counter()
            x_dev, _ = ck.restore(step, like=0, device=dev)
            sync()
            report.restore_s += time.perf_counter() - t0
            run = build(p_cur, seg + 1)
            report.restarts += 1
            report.events.append(
                (seg, "restart", f"survivors={members} p={p_cur} "
                                 f"rollback_to={step}"))
            continue
        joining = tuple(sorted(
            w for w, s in plan.join_at.items()
            if s <= seg and w not in members
            and (w not in dead or s > plan.crash_at.get(w, -1))))
        if joining and not stalled:
            dead -= set(joining)          # a repaired worker rejoins clean
            members = tuple(sorted(set(members) | set(joining)))
            hb.register(joining, t_end)
            # workers beyond the slots stay spares: members for the control
            # plane, not shards
            p_new = shrink_to_fit(n, min(len(members), slots), cfg.reduction)
            report.events.append(
                (seg, "join", f"workers {joining} p={p_cur}->{p_new}"))
            if p_new != p_cur:
                # hot scale-up: the live state runs on at the new count
                p_cur = p_new
                run = build(p_cur, seg + 1)
        if not stalled and (seg + 1) % int(ckpt_every) == 0:
            save()       # async

    flush()
    report.outer_iters = outer_done
    report.members_final = members
    report.stragglers_flagged = sorted(flagged)
    report.x = x_dev
    return report
