"""Asynchronous shard runtime — the paper's execution model on one device.

Each of ``p`` shards owns an x-pencil of the convection–diffusion grid and
the *ingredients of asynchrony are explicit, per-shard quantities*:

* **heterogeneous progress** — shard i performs ``inner_sweeps[i]`` local
  sweeps per exchange,
* **stale halos** — every exchange lands in a ring of delayed neighbour
  views; shard i *consumes* the view from ``halo_delay[i]`` exchanges ago,
* **k-lagged reduction lanes** — in non-blocking mode shard i's reduction
  contribution is its local residual from ``contrib_lag[i]`` checks ago.

The shards run over a *stacked single-process transport*: the ``p`` blocks
live in one process on one device, a halo exchange hands each shard views
of its neighbours' faces, and the JAX package's ``psum``/``pmax`` become a
sum/max over the stacked shard lanes.  The global residual is produced
three ways (``core.reduction``), all through the same ``core.detection``
monitor:

* ``blocking``    — an *extra* residual-only pass over the fresh
  post-exchange state, consumed the same step (the synchronous reference);
* ``nonblocking`` — the paper: the contribution is the free by-product of
  the last inner sweep, lanes are k-lagged and the monitor consumes the
  reduction launched K checks earlier;
* ``rdoubling``   — modified recursive doubling: one XOR-partner butterfly
  round per outer step; a global value completes every log2(p) steps.

Every sweep and contribution goes through the kernel ops (``jacobi3d``
sweeps and residual passes, ``residual_norm.update_contribution``), so on
the card the main path runs the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core import residual as res
from repro_torch.core.reduction import get_reduction
from repro_torch.kernels.jacobi3d import ops as jac_ops
from repro_torch.kernels.residual_norm import ops as rn_ops
from repro_torch.solvers import jacobi
from repro_torch.solvers.convdiff import Stencil
from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted


def _per_shard(v: Union[int, Sequence[int]], p: int, name: str) -> np.ndarray:
    """Broadcast/validate a per-shard config field: a scalar broadcasts over
    all ``p`` shards; a sequence must have length ``p``."""
    arr = np.full(p, v, dtype=np.int64) if np.isscalar(v) else \
        np.asarray(v, dtype=np.int64)
    if arr.shape != (p,):
        raise ValueError(f"{name} must be a scalar or length-{p}, got {arr.shape}")
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

    def __post_init__(self):
        get_reduction(self.reduction)
        if self.sweep not in ("jacobi", "hybrid"):
            raise ValueError(f"sweep {self.sweep!r} not in ('jacobi', 'hybrid')")

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
    """Per-shard view of the problem; ``i`` is the shard index."""

    exchange: Callable       # [x_i] -> [ghosts_i] (the per-step halo exchange)
    sweep: Callable          # (i, x_i, ghosts_i) -> x_i'
    sweep_contrib: Callable  # (i, x_i, ghosts_i) -> (x_i', pre-σ contrib)
    exact_contrib: Callable  # (i, x_i, ghosts_i) -> pre-σ contrib of x_i


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
# Reductions over the stacked shard lanes
# ---------------------------------------------------------------------------


def _preduce(lanes: torch.Tensor, ord: float) -> torch.Tensor:
    """Pre-σ global reduction of the per-shard lanes ``[p]`` (sum / max);
    σ is applied by ``detection.step``."""
    return lanes.amax() if np.isinf(ord) else lanes.sum()


def _butterfly_rounds(p: int) -> int:
    if p & (p - 1):
        raise ValueError(f"rdoubling requires a power-of-two shard count, got {p}")
    return max(p.bit_length() - 1, 0)


def _butterfly_step(lane: torch.Tensor, partial: torch.Tensor,
                    visible: torch.Tensor, k: int, perms: List[torch.Tensor],
                    ord: float):
    """One round of the modified recursive-doubling reduction over the
    stacked lanes ``[p]``: round ``k mod log2(p)`` combines each shard's
    partial with its XOR partner's (``perms[r][i] = i ^ 2^r``); a completed
    global value becomes visible every log2(p) steps.  Returns
    ``(partial, visible)``."""
    rounds = len(perms)
    if rounds == 0:  # single shard: the lane is the global value
        return lane, lane
    r = k % rounds
    base = lane if r == 0 else partial   # fresh epoch samples the lane
    recv = base.index_select(0, perms[r])
    total = torch.maximum(base, recv) if np.isinf(ord) else base + recv
    return total, (total if r == rounds - 1 else visible)


# ---------------------------------------------------------------------------
# Generic asynchronous shard loop
# ---------------------------------------------------------------------------


def _make_loop(cfg: ShardRuntimeConfig, p: int, device: torch.device):
    """Validate the per-shard config and return ``loop(prob, xs)``, which
    runs the shards (``xs``, updated in place) to detection or
    ``max_outer`` and returns ``(outer_iters, monitor_state, trace)``."""
    mon_cfg = cfg.effective_monitor()
    ord_ = mon_cfg.ord
    inner = _per_shard(cfg.inner_sweeps, p, "inner_sweeps")
    if (inner < 1).any():
        raise ValueError("inner_sweeps must be >= 1 per shard")
    delay = _per_shard(cfg.halo_delay, p, "halo_delay")
    lag = _per_shard(cfg.contrib_lag, p, "contrib_lag")
    mode = get_reduction(cfg.reduction)
    blocking, butterfly = mode.barrier, mode.topology == "butterfly"
    if blocking and (delay.any() or lag.any()):
        raise ValueError("blocking mode is the synchronous barrier reference: "
                         "halo_delay and contrib_lag must be 0")
    perms = []
    if butterfly:
        perms = [torch.tensor([i ^ (1 << r) for i in range(p)], device=device)
                 for r in range(_butterfly_rounds(p))]
    Lg, Lc = int(delay.max()) + 1, int(lag.max()) + 1
    tlen = max(int(cfg.trace_len), 1)

    def loop(prob: _ShardProblem, xs: List[torch.Tensor]):
        def exact(xs, ghosts) -> torch.Tensor:
            """Blocking exact reduction of the fresh state (σ applied)."""
            return res.psum_sigma(torch.stack(
                [prob.exact_contrib(i, xs[i], ghosts[i]) for i in range(p)]), ord_)

        inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
        gring = _ring_fill(prob.exchange(xs), Lg)
        crings = [_ring_fill(inf, Lc) for _ in range(p)]
        partial = visible = torch.full((p,), float("inf"), device=device)
        mon = detection.init_state(mon_cfg, device)
        trace = []
        k = 0
        while k < cfg.max_outer:
            contribs = []
            for i in range(p):
                ghosts = _ring_read(gring, k - int(delay[i]))[i]
                x = xs[i]
                for _ in range(int(inner[i]) - (0 if blocking else 1)):
                    x = prob.sweep(i, x, ghosts)
                c = None
                if not blocking:
                    x, c = prob.sweep_contrib(i, x, ghosts)
                xs[i] = x
                contribs.append(c)
            fresh = prob.exchange(xs)
            _ring_write(gring, fresh, k + 1)
            lanes = []
            for i in range(p):
                # barrier mode: detection pays a residual-only pass over the
                # fresh post-exchange state, every check
                c = contribs[i] if contribs[i] is not None else \
                    prob.exact_contrib(i, xs[i], fresh[i])
                _ring_write(crings[i], c, k)
                lanes.append(_ring_read(crings[i], k - int(lag[i])))
            lane = torch.stack(lanes)
            if butterfly:
                partial, visible = _butterfly_step(lane, partial, visible, k,
                                                   perms, ord_)
                g_pre = visible[0]  # every shard holds the same value
            else:
                g_pre = _preduce(lane, ord_)
            if k < tlen:
                trace.append(res.sigma(g_pre, ord_).to(torch.float32))
            mon = detection.step(
                mon_cfg, mon, g_pre,
                exact_residual_fn=lambda xs=list(xs), fresh=fresh: exact(xs, fresh))
            k += 1
            if bool(mon.converged):  # the loop's one device→host sync
                break
        trace = torch.stack(trace + [inf] * (tlen - len(trace)))
        return k, mon, trace

    return loop


# ---------------------------------------------------------------------------
# ConvDiff shards (1-D x-pencils, stale-halo exchange)
# ---------------------------------------------------------------------------


def make_convdiff_runtime(cfg: ShardRuntimeConfig, p: int, stencil: Stencil,
                          n: int, device: DeviceLike = None):
    """Build ``run(x0, b) -> ShardRunResult`` over ``p`` stacked shards.

    ``x0, b`` are global (n, n, n) tensors or numpy arrays (moved to
    ``device``, default ``cuda``).  Each shard owns an x-pencil of ``n // p``
    planes and exchanges its two x-faces per outer step (y/z faces are the
    physical boundary).
    """
    if n % p:
        raise ValueError(f"n={n} not divisible by shard count p={p}")
    ord_ = cfg.monitor.ord
    if not (np.isinf(ord_) or float(ord_) == 2.0):
        raise ValueError(f"the convdiff runtime supports ord 2 or inf, got {ord_}")
    dev = resolve_device(device)
    loop = _make_loop(cfg, p, dev)
    inner = _per_shard(cfg.inner_sweeps, p, "inner_sweeps")
    bx = n // p
    st = stencil

    def run(x0, b) -> ShardRunResult:
        b = torch.as_tensor(b, device=dev)
        x0 = torch.as_tensor(x0, device=dev, dtype=b.dtype)
        if tuple(b.shape) != (n, n, n) or x0.shape != b.shape:
            raise ValueError(f"x0 and b must be ({n}, {n}, {n})")
        bs = b.split(bx)
        zx, zy = b.new_zeros((n, n)), b.new_zeros((bx, n))

        def exchange(xs):
            return [(xs[i - 1][-1] if i > 0 else zx,
                     xs[i + 1][0] if i < p - 1 else zx) for i in range(p)]

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

        xs = list(x0.split(bx))  # sweeps return new blocks: x0 is not written
        k, mon, trace = loop(
            _ShardProblem(exchange, sweep, sweep_contrib, exact_contrib), xs)
        return ShardRunResult(
            x=torch.cat(xs), residual=mon.detected_residual, outer_iters=k,
            converged=bool(mon.converged), local_sweeps=k * inner,
            verifications=int(mon.verifications), trace=trace)

    return run


# ---------------------------------------------------------------------------
# Synchronous reference (parity oracle)
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
