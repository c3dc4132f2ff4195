"""Asynchronous shard runtime — the paper's execution model, on one device
or one shard per process.

Each of ``p`` shards owns an x-pencil of the convection–diffusion grid and
the *ingredients of asynchrony are explicit, per-shard quantities*:

* **heterogeneous progress** — shard i performs ``inner_sweeps[i]`` local
  sweeps per exchange,
* **stale halos** — every exchange lands in a ring of delayed neighbour
  views; shard i *consumes* the view from ``halo_delay[i]`` exchanges ago,
* **k-lagged reduction lanes** — in non-blocking mode shard i's reduction
  contribution is its local residual from ``contrib_lag[i]`` checks ago.

The shards run over one of two transports (``runtime/transport.py``),
driven by the same loop (``_make_loop``):

* the *stacked* transport (``p`` a shard count or mesh shape): the ``p``
  blocks live in one process on one device, a halo exchange hands each
  shard views of its neighbours' faces, and the JAX package's
  ``psum``/``pmax`` become a sum/max over the stacked shard lanes;
* the *process-group* transport (``p`` a ``launch.mesh.ShardGroup``): one
  shard per rank of a ``torch.distributed`` group (gloo or NCCL), as the
  JAX package runs one shard per device of a mesh.  Rank r places only its
  block (``launch.mesh.local_slices``), faces travel as point-to-point
  messages, the non-blocking reduction is an async ``all_reduce`` waited
  for K checks later, and the result is gathered to the global layout on
  every rank.

A configuration gives the same detection over either.  The global residual
is produced three ways (``core.reduction``), all decided by the same
``core.detection`` code:

* ``blocking``    — an *extra* residual-only pass over the fresh
  post-exchange state, consumed the same step (the synchronous reference);
* ``nonblocking`` — the paper: the contribution is the free by-product of
  the last inner sweep, lanes are k-lagged and the monitor consumes the
  reduction launched K checks earlier;
* ``rdoubling``   — modified recursive doubling: one XOR-partner butterfly
  round per outer step; a global value completes every log2(p) steps.

The grid is split into x-pencils (``p`` an int, the historical 1-D path)
or into the blocks of a 2-D/3-D mesh (``p`` a mesh shape such as ``(3, 2)``
or ``(2, 2, 2)``: ``solvers.partition.MeshPartition``, shards ranked
row-major as in the JAX package).  A mesh shard exchanges one face plane
per partitioned direction per outer step and sweeps through the
halo-consuming kernel ops, which read the six face planes where they lie.
With ``overlap`` the last sweep of a step first recomputes the new face
planes from thickness-1 slabs and launches their exchange, then sweeps the
whole block and waits for the exchange after it — bitwise the same result
as without overlap; over a process group the transfer hides behind the
sweep.

PageRank (``make_pagerank_runtime``) splits the state into ``p`` row
blocks of the dense operator; its exchange is the whole state view, one
all-gather of the blocks, and its sweep a row-block matvec.
``make_runtime`` picks the runtime by problem family.

Every sweep and contribution goes through the kernel ops (``jacobi3d``
sweeps and residual passes, ``residual_norm.update_contribution``), so on
the card the main path runs the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core import residual as res
from repro_torch.core.reduction import get_reduction
from repro_torch.kernels.jacobi3d import ops as jac_ops
from repro_torch.kernels.jacobi3d.jacobi3d import fused_sweep_residual_halo
from repro_torch.kernels.residual_norm import ops as rn_ops
from repro_torch.launch.mesh import ShardGroup, local_slices, mesh_shape, place_blocks
from repro_torch.runtime.transport import (
    DryTransport,
    Pending,
    ReductionPipeline,
    make_transport,
)
from repro_torch.solvers import jacobi
from repro_torch.solvers.convdiff import Stencil
from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted
from repro_torch.solvers.partition import MeshPartition


def _per_shard(v: Union[int, Sequence[int]], p: int, name: str,
               mesh_shape: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """Broadcast/validate a per-shard config field: a scalar broadcasts over
    all ``p`` shards (row-major over the mesh axes); a sequence must match
    the *total* shard count of the mesh, whatever its dimensionality."""
    arr = np.full(p, v, dtype=np.int64) if np.isscalar(v) else \
        np.asarray(v, dtype=np.int64)
    if arr.shape != (p,):
        where = (f" — mesh shape {tuple(mesh_shape)} has {p} shards total, "
                 "row-major" if mesh_shape is not None else "")
        raise ValueError(
            f"{name} must be a scalar or length-{p}{where}, got {arr.shape}")
    if (arr < 0).any():
        raise ValueError(f"{name} must be >= 0, got {arr.tolist()}")
    return arr


@dataclass(frozen=True)
class ShardRuntimeConfig:
    """Configuration of the asynchronous shard loop (per-shard fields accept
    a scalar or a length-p sequence)."""

    monitor: detection.MonitorConfig
    reduction: str = "nonblocking"   # blocking | nonblocking | rdoubling
    inner_sweeps: Union[int, Sequence[int]] = 1   # per-shard sweeps/exchange
    halo_delay: Union[int, Sequence[int]] = 0     # per-shard neighbour-view age
    contrib_lag: Union[int, Sequence[int]] = 0    # per-shard reduction-lane age
    max_outer: int = 10_000
    trace_len: int = 0               # >0: record the launched-residual series
    sweep: str = "jacobi"            # "jacobi" | "hybrid"
    mesh_shape: Optional[Tuple[int, ...]] = None  # (px[,py[,pz]]); None = 1-D
    overlap: bool = False            # face slabs swept and shipped first

    def __post_init__(self):
        get_reduction(self.reduction)
        if self.sweep not in ("jacobi", "hybrid"):
            raise ValueError(f"sweep {self.sweep!r} not in ('jacobi', 'hybrid')")
        if self.mesh_shape is not None:
            shape = tuple(int(s) for s in self.mesh_shape)
            if not 1 <= len(shape) <= 3 or any(s < 1 for s in shape):
                raise ValueError(
                    f"mesh_shape {self.mesh_shape!r} must be a tuple of 1-3 "
                    "positive ints (px,), (px, py) or (px, py, pz)")
            object.__setattr__(self, "mesh_shape", shape)
        if self.overlap:
            if self.sweep != "jacobi":
                raise ValueError(
                    "overlap=True requires sweep='jacobi': the red-black "
                    "ordering serializes face updates behind the colour "
                    "pass, so there is no independent slab to ship early")
            if self.reduction == "blocking":
                raise ValueError(
                    "overlap=True is incompatible with the blocking barrier "
                    "reference (its exact pass already serializes the step)")

    def effective_monitor(self) -> detection.MonitorConfig:
        """Monitor as the runtime runs it: blocking and recursive doubling
        force the monitor's K to 0; non-blocking keeps the configured
        staleness (the in-flight window)."""
        if get_reduction(self.reduction).forces_zero_staleness \
                and self.monitor.staleness:
            return dataclasses.replace(self.monitor, staleness=0)
        return self.monitor


class ShardRunResult(NamedTuple):
    x: torch.Tensor            # solution, global layout
    residual: torch.Tensor     # f32 — the (possibly stale) residual that fired
    outer_iters: int           # exchanges performed
    converged: bool
    local_sweeps: np.ndarray   # [p] per-shard sweep counts (heterogeneous)
    verifications: int         # NFAIS2 blocking verifications paid
    trace: torch.Tensor        # f32[max(trace_len, 1)] launched residual per step


class _ShardProblem(NamedTuple):
    """Per-shard view of the problem.  ``i`` is a shard's rank; ``xs`` and
    the ghost maps are ``{i: ...}`` over the transport's local shards."""

    exchange: Callable       # {i: x_i} -> {i: ghosts_i} (the per-step halo exchange)
    sweep: Callable          # (i, x_i, ghosts_i) -> x_i'
    sweep_contrib: Callable  # (i, x_i, ghosts_i) -> (x_i', pre-σ contrib)
    exact_contrib: Callable  # (i, x_i, ghosts_i) -> pre-σ contrib of x_i
    # comm overlap: ``faces(i, x_i, ghosts_i)`` recomputes the new face
    # planes as thin slabs *before* the full-block sweep, and ``ship({i:
    # faces_i})`` launches their exchange, a ``Pending`` of the ghost map
    # (None: no overlap)
    faces: Optional[Callable] = None
    ship: Optional[Callable] = None
    # contributions from one launch over all the local shards, in place of
    # the per-shard ``sweep_contrib`` / ``exact_contrib``:
    # ``sweep_contribs(xs, ghosts) -> ({i: x_i'}, {i: contrib})`` and
    # ``exact_contribs(xs, ghosts) -> {i: contrib}`` (None: per shard)
    sweep_contribs: Optional[Callable] = None
    exact_contribs: Optional[Callable] = None
    # ``begin(k)`` is called at the start of outer step k (None: nothing)
    begin: Optional[Callable] = None

    def sweep_all(self, xs, ghosts):
        if self.sweep_contribs is not None:
            return self.sweep_contribs(xs, ghosts)
        out = {i: self.sweep_contrib(i, xs[i], ghosts[i]) for i in xs}
        return {i: o[0] for i, o in out.items()}, {i: o[1] for i, o in out.items()}

    def exact_all(self, xs, ghosts):
        if self.exact_contribs is not None:
            return self.exact_contribs(xs, ghosts)
        return {i: self.exact_contrib(i, xs[i], ghosts[i]) for i in xs}


# ---------------------------------------------------------------------------
# Rings (delayed neighbour views / k-lagged lanes).  The step is a host int,
# so a ring is a Python list of per-slot values, written in place.
# ---------------------------------------------------------------------------


def _ring_write(ring: list, value, step: int) -> None:
    """Write ``value`` at slot ``step mod L``."""
    ring[step % len(ring)] = value


def _ring_read(ring: list, step: int):
    """Read slot ``max(step, 0) mod L``."""
    return ring[max(step, 0) % len(ring)]


def _ring_fill(value, length: int) -> list:
    """A ring with ``value`` in every slot (valid initial views for any
    delay)."""
    return [value] * length


# ---------------------------------------------------------------------------
# Recursive doubling
# ---------------------------------------------------------------------------


def _butterfly_rounds(p: int) -> int:
    if p & (p - 1):
        raise ValueError(f"rdoubling requires a power-of-two shard count, got {p}")
    return max(p.bit_length() - 1, 0)


def _butterfly_step(transport, lanes: Dict[int, torch.Tensor],
                    partial: Dict[int, torch.Tensor], visible: Dict[int, torch.Tensor],
                    k: int, rounds: int, ord: float):
    """One round of the modified recursive-doubling reduction over the
    local shards' lanes: round ``r = k mod log2(p)`` combines each shard's
    partial with its XOR partner's (``i ^ 2^r``, one message each way); a
    completed global value becomes visible every log2(p) steps.  ``+`` and
    ``max`` commute, so every shard holds the same bits.  Returns
    ``(partial, visible)``."""
    if rounds == 0:  # single shard: the lane is the global value
        return lanes, lanes
    r = k % rounds
    base = lanes if r == 0 else partial   # fresh epoch samples the lane
    got = transport.route({i: {(i ^ (1 << r), "bf"): base[i]} for i in base}).wait()
    comb = torch.maximum if np.isinf(ord) else torch.add
    total = {i: comb(base[i], got[i][i ^ (1 << r), "bf"]) for i in base}
    return total, (total if r == rounds - 1 else visible)


# ---------------------------------------------------------------------------
# Generic asynchronous shard loop
# ---------------------------------------------------------------------------


def _make_loop(cfg: ShardRuntimeConfig, transport,
               mesh_shape: Optional[Tuple[int, ...]] = None):
    """Validate the per-shard config and return ``loop(prob, xs)``, which
    runs the local shards (``xs``, updated in place) to detection or
    ``max_outer`` and returns ``(outer_iters, monitor_state, trace)``.
    Both transports run this loop; every rank leaves it at the same step,
    since ``converged`` is decided from the reduced value.  A dry rank
    (``meta``) cannot read ``converged`` and runs ``max_outer`` steps."""
    p, device = transport.p, transport.device
    dry = isinstance(transport, DryTransport)
    mon_cfg = cfg.effective_monitor()
    ord_ = mon_cfg.ord
    inner = _per_shard(cfg.inner_sweeps, p, "inner_sweeps", mesh_shape)
    if (inner < 1).any():
        raise ValueError("inner_sweeps must be >= 1 per shard")
    delay = _per_shard(cfg.halo_delay, p, "halo_delay", mesh_shape)
    lag = _per_shard(cfg.contrib_lag, p, "contrib_lag", mesh_shape)
    mode = get_reduction(cfg.reduction)
    blocking, butterfly = mode.barrier, mode.topology == "butterfly"
    if blocking and (delay.any() or lag.any()):
        raise ValueError("blocking mode is the synchronous barrier reference: "
                         "halo_delay and contrib_lag must be 0")
    rounds = _butterfly_rounds(p) if butterfly else 0
    Lg, Lc = int(delay.max()) + 1, int(lag.max()) + 1

    def loop(prob: _ShardProblem, xs: Dict[int, torch.Tensor]):
        local = tuple(xs)
        overlapped = prob.faces is not None
        inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
        # overlap double-buffers the halo ring: the exchange of step k+1
        # lands in a slot the sweep of step k does not read
        gring = _ring_fill(prob.exchange(xs), max(Lg, 2) if overlapped else Lg)
        crings = {i: _ring_fill(inf, Lc) for i in local}
        partial = visible = dict.fromkeys(local, inf)
        reductions = ReductionPipeline(mon_cfg.staleness, ord_, cfg.trace_len, device)
        mon = detection.init_state(mon_cfg, device)
        k = 0
        while k < cfg.max_outer:
            if prob.begin is not None:
                prob.begin(k)
            ghosts = {i: _ring_read(gring, k - int(delay[i]))[i] for i in local}
            for i in local:
                for _ in range(int(inner[i]) - (0 if blocking else 1)):
                    xs[i] = prob.sweep(i, xs[i], ghosts[i])
            # overlap: the new faces are shipped while the full blocks sweep
            shipped = prob.ship({i: prob.faces(i, xs[i], ghosts[i]) for i in local}) \
                if overlapped else None
            if not blocking:
                news, contribs = prob.sweep_all(xs, ghosts)
                xs.update(news)
            fresh = shipped.wait() if overlapped else prob.exchange(xs)
            _ring_write(gring, fresh, k + 1)
            # barrier mode: detection pays a residual-only pass over the
            # fresh post-exchange state, every check
            if blocking:
                contribs = prob.exact_all(xs, fresh)
            lanes = {}
            for i in local:
                _ring_write(crings[i], contribs[i], k)
                lanes[i] = _ring_read(crings[i], k - int(lag[i]))
            if butterfly:
                partial, visible = _butterfly_step(transport, lanes, partial, visible,
                                                   k, rounds, ord_)
                reductions.launch(Pending.done(visible[local[0]]))
            else:
                reductions.launch(transport.reduce(lanes, ord_))
            mon = detection.decide(
                mon_cfg, mon, reductions.consume(),
                exact_residual_fn=lambda: transport.exact(prob.exact_all(xs, fresh), ord_))
            k += 1
            if not dry and bool(mon.converged):  # the loop's one device→host sync
                break
        return k, mon, reductions.drain()

    return loop


# ---------------------------------------------------------------------------
# Placement and results, shared by the families
# ---------------------------------------------------------------------------


def _group_of(p) -> Optional[ShardGroup]:
    return p if isinstance(p, ShardGroup) else None


def _transport_of(p, device: DeviceLike):
    """The transport of ``p``: a ``ShardGroup`` (whose device the run uses)
    or a shard count stacked on ``device`` (default ``cuda``)."""
    if isinstance(p, ShardGroup):
        if device is not None and torch.device(device).type != p.device.type:
            raise ValueError(f"a shard group runs on its own device {p.device}, "
                             f"not {device}")
        return make_transport(p, p.device)
    return make_transport(p, resolve_device(device))


def _blocks(a, transport, slices: Sequence[tuple], gshape: Tuple[int, ...],
            what: str, dtype: Optional[torch.dtype] = None) -> Dict[int, torch.Tensor]:
    """The local shards' blocks of ``a`` on the transport's device
    (``launch.mesh.place_blocks``)."""
    return place_blocks(a, {i: slices[i] for i in transport.local}, transport.device,
                        dtype, gshape=gshape, what=what)


def _result(transport, xs, assemble, mon, k: int, inner: np.ndarray,
            trace: torch.Tensor) -> ShardRunResult:
    """The run's result, the same on every rank: ``x`` gathered to the
    global layout, ``local_sweeps`` the per-shard vector.  A dry rank
    returns its own block and the monitor's tensors as they lie, as the
    JAX program returns its sharded state: no gather."""
    if isinstance(transport, DryTransport):
        (x,) = xs.values()
        return ShardRunResult(
            x=x, residual=mon.detected_residual, outer_iters=k, converged=mon.converged,
            local_sweeps=k * inner, verifications=mon.verifications, trace=trace)
    return ShardRunResult(
        x=assemble(transport.all_gather(xs)), residual=mon.detected_residual,
        outer_iters=k, converged=bool(mon.converged), local_sweeps=k * inner,
        verifications=int(mon.verifications), trace=trace)


# ---------------------------------------------------------------------------
# ConvDiff shards (1-D x-pencils, stale-halo exchange)
# ---------------------------------------------------------------------------


def make_convdiff_runtime(cfg: ShardRuntimeConfig,
                          p: Union[int, Tuple[int, ...], ShardGroup], stencil: Stencil,
                          n: int, device: DeviceLike = None):
    """Build ``run(x0, b) -> ShardRunResult``.

    ``p`` is a shard count or mesh shape (the stacked transport, on
    ``device``, default ``cuda``) or a ``ShardGroup`` (one shard per rank,
    on the group's device; the JAX package passes a mesh here).  ``x0, b``
    are global (n, n, n) tensors or numpy arrays (over a group, or the
    rank's block; each rank places its block only).  With a 1-D ``p`` each
    of the ``p`` shards owns an x-pencil of ``n // p`` planes and exchanges
    its two x-faces per outer step (y/z faces are the physical boundary).
    A mesh shape ``(px, py[, pz])`` — or ``cfg.overlap`` — routes to the
    block-decomposed mesh runtime, as the JAX package routes a multi-axis
    mesh; ``cfg.mesh_shape``, when set, must name the same mesh.
    """
    group = _group_of(p)
    mesh = group.shape if group else mesh_shape(p)
    if cfg.mesh_shape is not None and cfg.mesh_shape != mesh:
        raise ValueError(f"cfg.mesh_shape {cfg.mesh_shape} does not match the "
                         f"mesh shape {mesh}")
    if len(mesh) > 1 or cfg.overlap:
        return _make_convdiff_mesh_runtime(cfg, group or mesh, stencil, n, device)
    p = mesh[0]
    if n % p:
        raise ValueError(f"n={n} not divisible by shard count p={p}")
    res.partial_mode(cfg.monitor.ord)  # the kernel ops run ord 1, 2 or inf only
    ord_ = cfg.monitor.ord
    transport = _transport_of(group or p, device)
    dev = transport.device
    loop = _make_loop(cfg, transport)
    inner = _per_shard(cfg.inner_sweeps, p, "inner_sweeps")
    bx = n // p
    slices = [local_slices("convdiff", mesh, n, i) for i in range(p)]
    st = stencil

    def run(x0, b) -> ShardRunResult:
        what = f"x0 and b must be ({n}, {n}, {n})"
        bs = _blocks(b, transport, slices, (n, n, n), what)
        dtype = next(iter(bs.values())).dtype
        xs = _blocks(x0, transport, slices, (n, n, n), what, dtype)
        zx = torch.zeros((n, n), dtype=dtype, device=dev)
        zy = torch.zeros((bx, n), dtype=dtype, device=dev)

        def exchange(xs):
            # two shift directions, the JAX program's two permutes
            got = transport.route({i: {**({(i - 1, 0): xs[i][0]} if i > 0 else {}),
                                       **({(i + 1, 0): xs[i][-1]} if i < p - 1 else {})}
                                   for i in xs}, permutes=2).wait()
            return {i: (got[i].get((i - 1, 0), zx), got[i].get((i + 1, 0), zx))
                    for i in xs}

        def ghosts4(ghosts):
            return ghosts + (zy, zy)  # y ghosts = BC = 0

        def sweep(i, x, ghosts):
            return jac_ops.sweep(st, x, ghosts4(ghosts), bs[i],
                                 sweep=cfg.sweep, ox=i * bx, oy=0)

        def sweep_contrib(i, x, ghosts):
            if cfg.sweep == "jacobi":
                new = jac_ops.sweep(st, x, ghosts4(ghosts), bs[i])
                # Jacobi residual is the update difference scaled by the
                # diagonal: fused diff-norm via the residual_norm kernel ops
                return new, rn_ops.update_contribution(new, x, ord=ord_,
                                                       scale=st.diag)
            return jac_ops.sweep_with_contribution(
                st, x, ghosts4(ghosts), bs[i], sweep="hybrid", ox=i * bx,
                oy=0, ord=ord_)

        def exact_contrib(i, x, ghosts):
            return jac_ops.residual_contribution(
                st, ghosted(x, ghosts4(ghosts)), bs[i], ord=ord_)

        # sweeps return new blocks: x0 is not written
        k, mon, trace = loop(
            _ShardProblem(exchange, sweep, sweep_contrib, exact_contrib), xs)
        return _result(transport, xs, torch.cat, mon, k, inner, trace)

    return run


# ---------------------------------------------------------------------------
# ConvDiff shards on a 2-D/3-D mesh (blocks, per-face stale-halo exchange)
# ---------------------------------------------------------------------------


def _make_convdiff_mesh_runtime(cfg: ShardRuntimeConfig,
                                p: Union[Tuple[int, ...], ShardGroup],
                                stencil: Stencil, n: int, device: DeviceLike):
    """Multi-axis (or comm-overlapped) convdiff runtime.

    The grid tiles by ``MeshPartition(n, shape)``: shard i (row-major rank)
    owns an ``n/px × n/py × n/pz`` block and exchanges one face plane per
    partitioned direction per outer step; faces on unpartitioned directions
    are the physical boundary (ghost value 0).  Sweeps go through the
    halo-consuming ops (``sweep_halo``/``sweep_with_contribution_halo``),
    whose kernels keep the single-pass fused sweep + residual, so every
    reduction consumes the same free by-product as the 1-D path.

    With ``cfg.overlap`` the last sweep of each step first recomputes the
    new face planes from thickness-1 slabs by the same halo kernel
    (bitwise the faces the full sweep produces: same inputs, same
    operations) and launches their exchange; the full fused sweep then runs
    with no dependence on them, and the exchange is waited for after it.
    """
    group = _group_of(p)
    shape = group.shape if group else p
    part = MeshPartition(n, shape)
    p = part.p
    block = part.block                                  # (bx, by, bz)
    parted = tuple(d for d in range(part.ndim) if shape[d] > 1)
    plane = {0: (block[1], block[2]), 1: (block[0], block[2]),
             2: (block[0], block[1])}
    if cfg.overlap:
        for d in parted:
            if block[d] < 2:
                raise ValueError(
                    "overlap=True needs block extent >= 2 on every "
                    f"partitioned axis: mesh {shape} at n={n} gives "
                    f"block {block}")
    res.partial_mode(cfg.monitor.ord)  # the kernel ops run ord 1, 2 or inf only
    ord_ = cfg.monitor.ord
    transport = _transport_of(group or p, device)
    dev = transport.device
    loop = _make_loop(cfg, transport, mesh_shape=shape)
    inner = _per_shard(cfg.inner_sweeps, p, "inner_sweeps", shape)
    st = stencil
    offsets = [part.offsets(i) for i in range(p)]
    slices = [local_slices("convdiff", shape, n, i) for i in range(p)]
    # per shard and partitioned direction: the (minus, plus) neighbour
    # ranks, None at the mesh edge
    nbrs = []
    for i in range(p):
        c = part.coords(i)
        nbrs.append({d: tuple(part.rank(*c[:d], c[d] + s, *c[d + 1:])
                              if 0 <= c[d] + s < shape[d] else None
                              for s in (-1, 1)) for d in parted})

    def run(x0, b) -> ShardRunResult:
        what = f"x0 and b must be ({n}, {n}, {n})"
        bs = _blocks(b, transport, slices, (n, n, n), what)
        dtype = next(iter(bs.values())).dtype
        xs = _blocks(x0, transport, slices, (n, n, n), what, dtype)
        zeros = {d: torch.zeros(plane[d], dtype=dtype, device=dev) for d in range(3)}

        def ship(faces):
            """Shard i sends its minus face to its minus neighbour and its
            plus face to its plus neighbour, so its minus ghost is shard
            c−1's plus face and its plus ghost shard c+1's minus face; the
            mesh edges get the zero plane."""
            sends = {i: {(j, d): faces[i][d][side] for d in parted
                         for side, j in enumerate(nbrs[i][d]) if j is not None}
                     for i in faces}
            return transport.route(sends).then(lambda got: {
                i: {d: tuple(zeros[d] if j is None else got[i][j, d] for j in nbrs[i][d])
                    for d in parted} for i in got})

        def exchange(xs):
            return ship({i: {d: (x.select(d, 0).contiguous(),
                                 x.select(d, -1).contiguous()) for d in parted}
                         for i, x in xs.items()}).wait()

        def halos6(ghosts):
            """The six face planes: exchanged ghosts on partitioned
            directions, zeros (physical BC) elsewhere."""
            return tuple(h for d in range(3)
                         for h in ghosts.get(d, (zeros[d], zeros[d])))

        def sweep(i, x, ghosts):
            return jac_ops.sweep_halo(st, x, halos6(ghosts), bs[i], sweep=cfg.sweep,
                                      ox=offsets[i][0], oy=offsets[i][1],
                                      oz=offsets[i][2])

        def sweep_contrib(i, x, ghosts):
            return jac_ops.sweep_with_contribution_halo(
                st, x, halos6(ghosts), bs[i], sweep=cfg.sweep, ox=offsets[i][0],
                oy=offsets[i][1], oz=offsets[i][2], ord=ord_)

        def exact_contrib(i, x, ghosts):
            return jac_ops.residual_contribution_halo(st, x, halos6(ghosts), bs[i],
                                                      ord=ord_)

        def face_sweep(x, h6, b, d, last):
            """The new values of one face of the block, as the full Jacobi
            sweep will produce them, from a thickness-1 slab and its six
            planes: along the face normal one side is the landed ghost and
            the other the adjacent in-block plane (block extent >= 2);
            transverse planes are the block's, restricted to the slab."""
            idx = x.shape[d] - 1 if last else 0
            sg = []
            for e in range(3):
                if e == d:
                    sg += [x.select(d, idx - 1), h6[2 * d + 1]] if last else \
                        [h6[2 * d], x.select(d, idx + 1)]
                else:
                    pos = d if d < e else d - 1   # axis d within e's plane
                    sg += [h6[2 * e].narrow(pos, idx, 1),
                           h6[2 * e + 1].narrow(pos, idx, 1)]
            new, _ = fused_sweep_residual_halo(
                x.narrow(d, idx, 1).contiguous(), sg,
                b.narrow(d, idx, 1).contiguous(), st.coefs, op="sweep")
            return new.squeeze(d)

        def faces(i, x, ghosts):
            h = halos6(ghosts)
            return {d: (face_sweep(x, h, bs[i], d, False),
                        face_sweep(x, h, bs[i], d, True)) for d in parted}

        def assemble(blocks):
            x = torch.empty((n, n, n), dtype=dtype, device=dev)
            for sl, xi in zip(slices, blocks):
                x[sl] = xi
            return x

        prob = _ShardProblem(exchange, sweep, sweep_contrib, exact_contrib,
                             *((faces, ship) if cfg.overlap else ()))
        k, mon, trace = loop(prob, xs)   # sweeps return new blocks
        return _result(transport, xs, assemble, mon, k, inner, trace)

    return run


# ---------------------------------------------------------------------------
# PageRank shards (row blocks, stale concatenated state views)
# ---------------------------------------------------------------------------


def make_pagerank_runtime(cfg: ShardRuntimeConfig,
                          p: Union[int, Tuple[int, ...], ShardGroup],
                          n: int, damping: float = 0.85, device: DeviceLike = None):
    """Build ``run(x0, P_dense) -> ShardRunResult`` over ``p`` row blocks.

    ``p`` is a shard count (stacked on ``device``, default ``cuda``) or a
    1-D ``ShardGroup``.  ``x0`` is the global (n,) state and ``P_dense``
    the (n, n) column-stochastic operator, tensors or numpy arrays (over a
    group, or the rank's block and rows: a rank places its own rows only);
    shard i owns rows ``i·n/p`` onward.  The "halo" is the full state view,
    one all-gather of the shards' blocks that every ring slot holds by
    reference; staleness delays the *consumed* view, while a shard's own
    block is always current (the asynchronous-iterations convention).  The
    sweep is ``d · (P_rows @ view) + v``; its contribution is the update
    difference (scale 1) through ``residual_norm.update_contribution``, so
    on the card it is the diff-norm kernel.
    """
    group = _group_of(p)
    mesh = group.shape if group else mesh_shape(p)
    for shape in (mesh, cfg.mesh_shape or mesh):
        if len(shape) != 1:
            raise ValueError(
                f"pagerank shards are 1-D row blocks; got mesh shape {shape} — "
                "multi-axis meshes are convdiff-only")
    if cfg.overlap:
        raise ValueError("overlap=True is convdiff-only (pagerank has no "
                         "halo ring: its exchange is an all-gather)")
    p = mesh[0]
    if n % p:
        raise ValueError(f"n={n} not divisible by shard count p={p}")
    res.partial_mode(cfg.monitor.ord)  # the kernel ops run ord 1, 2 or inf only
    ord_ = cfg.monitor.ord
    transport = _transport_of(group or p, device)
    loop = _make_loop(cfg, transport)
    inner = _per_shard(cfg.inner_sweeps, p, "inner_sweeps")
    nb = n // p
    slices = [local_slices("pagerank", mesh, n, i) for i in range(p)]
    d = float(damping)
    v = (1.0 - d) / n

    def run(x0, P_dense) -> ShardRunResult:
        what = f"x0 must be ({n},) and P_dense ({n}, {n})"
        rows = _blocks(P_dense, transport, slices, (n, n), what)
        dtype = next(iter(rows.values())).dtype
        xs = _blocks(x0, transport, slices, (n,), what, dtype)

        def exchange(xs):
            # the all-gather: one view, a reference for every local shard
            view = torch.cat(transport.all_gather(xs))
            return dict.fromkeys(xs, view)

        def own_current(i, x, view):
            """The view with shard i's block replaced by its current state,
            in a fresh tensor (the ring's view is shared and not written)."""
            return torch.cat((view[:i * nb], x, view[(i + 1) * nb:]))

        def sweep(i, x, view):
            return d * (rows[i] @ own_current(i, x, view)) + v

        def sweep_contrib(i, x, view):
            new = sweep(i, x, view)
            # D-iteration residual = the update difference (scale 1)
            return new, rn_ops.update_contribution(new, x, ord=ord_)

        def exact_contrib(i, x, view):
            return res.local_contribution(sweep(i, x, view) - x, ord_)

        # sweeps return new blocks: x0 is not written
        k, mon, trace = loop(
            _ShardProblem(exchange, sweep, sweep_contrib, exact_contrib), xs)
        return _result(transport, xs, torch.cat, mon, k, inner, trace)

    return run


# ---------------------------------------------------------------------------
# Family dispatch
# ---------------------------------------------------------------------------


FAMILIES = ("convdiff", "pagerank")


def make_runtime(family: str, cfg: ShardRuntimeConfig,
                 p: Union[int, Tuple[int, ...], ShardGroup], n: int, *,
                 stencil: Optional[Stencil] = None, damping: float = 0.85,
                 device: DeviceLike = None):
    """``run(x0, problem_arg) -> ShardRunResult`` for a problem family, over
    the stacked transport (``p`` a shard count or mesh shape) or a
    ``ShardGroup``."""
    if family == "convdiff":
        if stencil is None:
            raise ValueError("convdiff runtime requires stencil=")
        return make_convdiff_runtime(cfg, p, stencil, n, device)
    if family == "pagerank":
        return make_pagerank_runtime(cfg, p, n, damping, device)
    raise KeyError(f"family {family!r} not in {FAMILIES}")


# ---------------------------------------------------------------------------
# Synchronous references (parity oracles)
# ---------------------------------------------------------------------------


def convdiff_reference_trace(stencil: Stencil, b: torch.Tensor, steps: int,
                             ord: float = 2.0, x0=None) -> torch.Tensor:
    """Global synchronous Jacobi trajectory in plain PyTorch: entry k is the
    exact residual after k+1 sweeps — what the blocking runtime must
    reproduce."""
    x = torch.zeros_like(b) if x0 is None else x0
    zg = _zero_ghosts(x)
    out = []
    for _ in range(steps):
        x = jacobi.jacobi_sweep(stencil, ghosted(x, zg), b)
        r = res.local_contribution(
            jacobi.residual_block(stencil, ghosted(x, zg), b), ord)
        out.append(res.sigma(r, ord).to(torch.float32))
    return torch.stack(out)


def pagerank_reference_trace(P_dense: torch.Tensor, n: int, steps: int,
                             damping: float = 0.85,
                             ord: float = 1.0) -> torch.Tensor:
    """Global synchronous D-iteration trajectory in plain PyTorch (post-step
    residuals) — what the blocking PageRank runtime must reproduce."""
    d = float(damping)
    v = (1.0 - d) / n
    x = torch.full((n,), 1.0 / n, dtype=P_dense.dtype, device=P_dense.device)
    out = []
    for _ in range(steps):
        x = d * (P_dense @ x) + v
        r = res.local_contribution(d * (P_dense @ x) + v - x, ord)
        out.append(res.sigma(r, ord).to(torch.float32))
    return torch.stack(out)
