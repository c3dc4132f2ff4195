"""Asynchronous data-parallel training runtime — SGD convergence certified
by the protocol-free non-blocking residual.

Each shard is a data-parallel worker holding a full parameter replica and a
row shard of the training set (``solvers/mlfixed.py`` tasks: ridge least
squares or ℓ2-regularised logistic regression).  Per exchange round, shard i

1. consumes the *stale* parameter average from ``view_delay[i]`` rounds
   ago (the delayed all-reduce of async data parallelism),
2. runs ``inner_steps[i]`` local SGD steps on its own rows, rotating
   deterministically through ``num_batches`` minibatches (batch
   ``(k·s + t) mod num_batches`` at step t of round k),
3. publishes its new replica into the next average.

The state is the replica stack X = (x_1 … x_p), worker i's update is
T_i(X) = LocalSGD_i^{s_i}(mean(X)), and the residual is the update
difference T_i(X) − x_i: it vanishes exactly at the lifted fixed point.  So
global convergence is certified by the unchanged ``core.detection`` monitor
through the shard runtime's reduction modes (``core.reduction``):

* ``blocking``    — every round pays an extra evaluation pass of the worker
  map from the fresh average, consumed the same round (K forced 0);
* ``nonblocking`` — the contribution is the free by-product of the SGD
  step already taken, lanes k-lagged, the monitor consuming the reduction
  launched K rounds earlier;
* ``rdoubling``   — modified recursive doubling over the same lanes.

NFAIS2's verification evaluates the same map from the fresh average, paid
only when a candidate fires.

This is the port of the JAX package's ``runtime/train_async.py``, round for
round.  It runs on the shard runtime's loop (``shard_runtime._make_loop``)
over either transport: ``p`` a shard count (the replicas stacked on one
device) or a ``launch.mesh.ShardGroup`` (one replica per rank).  The
replica average is ``transport.replica_mean``, an all-gather, so a group's
run is bitwise its stacked twin's.  Each round's update-difference
contributions are one launch of the diff-norm kernel
(``residual_norm.row_contributions``): over the ``[p, n]`` replica stack,
one partial per replica, on the stacked transport, and over the rank's own
replica in a group.  The SGD products are library products
(``torch.mv``), as the JAX package's are plain ``jnp`` products.

The host oracles (``exact_train_residual``, ``reference_trace``) are the
JAX package's numpy code, copied.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core.reduction import get_reduction
from repro_torch.kernels.residual_norm import ops as rn_ops
from repro_torch.launch.mesh import ShardGroup, place_blocks
from repro_torch.runtime.shard_runtime import (
    ShardRuntimeConfig,
    _butterfly_rounds,
    _make_loop,
    _per_shard,
    _ShardProblem,
    _transport_of,
)
from repro_torch.runtime.transport import replica_mean
from repro_torch.solvers.mlfixed import MLFixedPointProblem, _sigmoid


@dataclass(frozen=True)
class TrainAsyncConfig:
    """Asynchrony knobs of the data-parallel loop (per-shard fields accept
    a scalar or a length-p sequence, like ``ShardRuntimeConfig``)."""

    monitor: detection.MonitorConfig
    reduction: str = "nonblocking"   # blocking | nonblocking | rdoubling
    inner_steps: Union[int, Sequence[int]] = 1   # local SGD steps / round
    view_delay: Union[int, Sequence[int]] = 0    # staleness of the average
    contrib_lag: Union[int, Sequence[int]] = 0   # reduction-lane age
    num_batches: int = 1             # minibatch rotation per shard
    gamma: Optional[float] = None    # None → safe_gamma(problem, p, nb)
    max_rounds: int = 10_000
    trace_len: int = 0               # >0: record launched residuals

    def __post_init__(self):
        get_reduction(self.reduction)  # registry validation at construction
        if self.num_batches < 1:
            raise ValueError(f"num_batches={self.num_batches} must be >= 1")

    def effective_monitor(self) -> detection.MonitorConfig:
        """Same convention as the shard runtime: blocking consumes its
        reduction immediately and recursive doubling pipelines internally,
        so both force the monitor's K to 0."""
        if get_reduction(self.reduction).forces_zero_staleness \
                and self.monitor.staleness:
            return dataclasses.replace(self.monitor, staleness=0)
        return self.monitor


class TrainRunResult(NamedTuple):
    x: torch.Tensor            # [p, n] final per-shard parameter replicas
    residual: torch.Tensor     # f32 — the (possibly stale) residual that fired
    rounds: int                # exchange rounds performed
    converged: bool
    local_steps: np.ndarray    # [p] per-shard SGD step counts
    verifications: int         # NFAIS2 synchronized evals paid
    loss: torch.Tensor         # final full-data objective Σ_i F_i(x_i)
    trace: torch.Tensor        # f32[max(trace_len, 1)] launched residual / round


# ---------------------------------------------------------------------------
# Step size: every worker's every minibatch map must contract
# ---------------------------------------------------------------------------


def _shard_rows(problem: MLFixedPointProblem, p: int):
    if problem.m % p:
        raise ValueError(f"m_rows={problem.m} not divisible by p={p}")
    m_loc = problem.m // p
    return [(problem.A[i * m_loc:(i + 1) * m_loc],
             problem.y[i * m_loc:(i + 1) * m_loc]) for i in range(p)]


def safe_gamma(problem: MLFixedPointProblem, p: int, num_batches: int = 1,
               device: DeviceLike = None) -> float:
    """Largest-curvature-safe step: 1 / max over (shard, minibatch) of the
    local gradient's Lipschitz bound, so every local map is a contraction
    (lstsq: eigmax(A_bᵀA_b/m_b) + λ; logistic: the σ'≤1/4 bound).  The
    largest singular value of each block is ``torch.linalg.svdvals`` on
    ``device`` (default ``cuda``), one batched call per shard."""
    dev = resolve_device(device)
    L = 0.0
    for A_loc, _ in _shard_rows(problem, p):
        m_loc = A_loc.shape[0]
        if m_loc % num_batches:
            raise ValueError(
                f"local rows {m_loc} not divisible by "
                f"num_batches={num_batches}")
        mb = m_loc // num_batches
        blocks = torch.as_tensor(np.asarray(A_loc)).to(dev).reshape(num_batches, mb, -1)
        top = torch.linalg.svdvals(blocks)[:, 0].cpu().numpy()
        del blocks
        for sv in top:
            if problem.task == "lstsq":
                L = max(L, sv * sv / mb + problem.l2)
            else:
                L = max(L, sv * sv / (4.0 * mb) + problem.l2)
    return float(1.0 / L)


# ---------------------------------------------------------------------------
# The device loop
# ---------------------------------------------------------------------------


def make_train_runtime(problem: MLFixedPointProblem, cfg: TrainAsyncConfig,
                       p: Union[int, ShardGroup], *, device: DeviceLike = None):
    """Build ``run(X0, A, y) -> TrainRunResult``.

    ``p`` is a shard count (the replicas stacked on ``device``, default
    ``cuda``) or a 1-D ``ShardGroup`` (one replica per rank, on the group's
    device); the JAX package passes a mesh here.  ``problem`` supplies
    ``m``, ``task`` and ``l2`` (and ``A``, ``y`` for ``safe_gamma`` when
    ``cfg.gamma`` is None).  ``X0`` is the [p, n] replica stack, ``A`` the
    [m, n] design and ``y`` the [m] targets (lstsq) or ±1 labels
    (logistic), tensors or numpy arrays; over a group, each may also be the
    rank's own rows (a [1, n] replica, m/p rows), and a rank places its
    rows only.
    """
    group = p if isinstance(p, ShardGroup) else None
    if group is not None and len(group.shape) != 1:
        raise ValueError(f"training shards are 1-D; got mesh shape {group.shape}")
    p = group.p if group else int(p)
    mon_cfg = cfg.effective_monitor()
    ord_ = mon_cfg.ord
    if problem.m % p:
        raise ValueError(f"m_rows={problem.m} not divisible by p={p}")
    m_loc = problem.m // p
    if m_loc % cfg.num_batches:
        raise ValueError(f"local rows {m_loc} not divisible by "
                         f"num_batches={cfg.num_batches}")
    mb = m_loc // cfg.num_batches
    nb = cfg.num_batches
    inner = _per_shard(cfg.inner_steps, p, "inner_steps")
    if (inner < 1).any():
        raise ValueError("inner_steps must be >= 1 per shard")
    delay = _per_shard(cfg.view_delay, p, "view_delay")
    lag = _per_shard(cfg.contrib_lag, p, "contrib_lag")
    if cfg.reduction == "blocking" and (delay.any() or lag.any()):
        raise ValueError("blocking mode is the synchronized reference: "
                         "view_delay and contrib_lag must be 0")
    if cfg.reduction == "rdoubling":
        _butterfly_rounds(p)
    transport = _transport_of(group or p, device)
    dev = transport.device
    gamma = float(cfg.gamma if cfg.gamma is not None
                  else safe_gamma(problem, p, nb, device=dev))
    l2, task, m, n = problem.l2, problem.task, problem.m, problem.n
    # the shard loop with one "sweep" per round: a worker's whole local
    # SGD round, whose step count is its own
    loop = _make_loop(ShardRuntimeConfig(
        monitor=cfg.monitor, reduction=cfg.reduction, inner_sweeps=1,
        halo_delay=cfg.view_delay, contrib_lag=cfg.contrib_lag,
        max_outer=cfg.max_rounds, trace_len=cfg.trace_len), transport)
    rows = {i: (slice(i * m_loc, (i + 1) * m_loc),) for i in range(p)}
    local = transport.local

    def grad_at(A_rows, y_rows, x):
        """Local-data gradient normalised by its own row count + full λ
        (so the mean over shards of local gradients is ∇F)."""
        if task == "lstsq":
            return A_rows.T @ (A_rows @ x - y_rows) / A_rows.shape[0] + l2 * x
        w = -y_rows * torch.sigmoid(-y_rows * (A_rows @ x))
        return A_rows.T @ w / A_rows.shape[0] + l2 * x

    def loss_at(A_rows, y_rows, x):
        """Local objective share F_i (Σ_i F_i = F at consensus)."""
        if task == "lstsq":
            r = A_rows @ x - y_rows
            return r @ r / (2.0 * m) + l2 * (x @ x) / (2.0 * p)
        margin = y_rows * (A_rows @ x)
        return torch.logaddexp(torch.zeros_like(margin), -margin).sum() / m \
            + l2 * (x @ x) / (2.0 * p)

    def run(X0, A, y) -> TrainRunResult:
        As = place_blocks(A, {i: rows[i] for i in local}, dev, gshape=(m, n),
                          what=f"A must be ({m}, {n})")
        dtype = next(iter(As.values())).dtype
        ys = place_blocks(y, {i: rows[i] for i in local}, dev, dtype, gshape=(m,),
                          what=f"y must be ({m},)")
        xs = {i: x.reshape(n) for i, x in place_blocks(
            X0, {i: (slice(i, i + 1),) for i in local}, dev, dtype, gshape=(p, n),
            what=f"X0 must be ({p}, {n})").items()}
        batches = {i: [(As[i][b * mb:(b + 1) * mb], ys[i][b * mb:(b + 1) * mb])
                       for b in range(nb)] for i in local}
        now = [0]   # the round the loop is in

        def sgd_steps(i, x, k):
            """Worker i's local minibatch steps from ``x``; the batch counter
            keeps rotating across rounds (phase k·steps + t mod nb)."""
            steps = int(inner[i])
            for t in range(steps):
                rows_b, tgt = batches[i][(k * steps + t) % nb]
                x = x - gamma * grad_at(rows_b, tgt, x)
            return x

        def contribs(news, olds):
            """Each local replica's pre-σ contribution of ``new − old``:
            one diff-norm launch over the local replicas."""
            if len(news) == 1:
                ((i, new),) = news.items()
                return {i: rn_ops.row_contributions(new, olds[i], ord_)}
            c = rn_ops.row_contributions(torch.stack([news[i] for i in local]),
                                         torch.stack([olds[i] for i in local]), ord_)
            return dict(zip(local, c.unbind()))

        def exchange(xs):
            # the (fresh) average: every local worker views the same tensor
            return dict.fromkeys(xs, replica_mean(transport, xs))

        def sweep(i, x, view):
            # blocking: the worker's round from the stale average
            return sgd_steps(i, view, now[0])

        def sweep_contribs(xs, views):
            # the paper: the update difference is already in hand
            news = {i: sgd_steps(i, views[i], now[0]) for i in xs}
            return news, contribs(news, xs)

        def exact_contribs(xs, fresh):
            # the synchronized eval: one more application of each worker's
            # map from the fresh average (blocking lanes, NFAIS2's verifier)
            return contribs({i: sgd_steps(i, fresh[i], now[0] + 1) for i in xs}, xs)

        def begin(k):
            now[0] = k

        prob = _ShardProblem(exchange, sweep, None, None,
                             sweep_contribs=sweep_contribs,
                             exact_contribs=exact_contribs, begin=begin)
        k, mon, trace = loop(prob, xs)
        shares = {i: loss_at(As[i], ys[i], xs[i]) for i in local}
        return TrainRunResult(
            x=torch.stack(transport.all_gather(xs)),
            residual=mon.detected_residual, rounds=k,
            converged=bool(mon.converged), local_steps=k * inner,
            verifications=int(mon.verifications),
            loss=torch.stack(transport.all_gather(shares)).sum(), trace=trace)

    return run


def init_replicas(problem: MLFixedPointProblem, p: int) -> np.ndarray:
    """Zero-initialised replica stack [p, n]."""
    return np.zeros((p, problem.n))


# ---------------------------------------------------------------------------
# Host-side oracles (numpy): the synchronized eval the async loop replaces
# ---------------------------------------------------------------------------


def _np_grad(A_rows, y_rows, x, task, l2):
    if task == "lstsq":
        return A_rows.T @ (A_rows @ x - y_rows) / A_rows.shape[0] + l2 * x
    w = -y_rows * _sigmoid(-y_rows * (A_rows @ x))
    return A_rows.T @ w / A_rows.shape[0] + l2 * x


def _np_contrib(r, ord_):
    if np.isinf(ord_):
        return float(np.max(np.abs(r)))
    return float(np.sum(np.abs(r) ** ord_))


def _np_sigma(c, ord_):
    if np.isinf(ord_):
        return float(c)
    return float(c ** (1.0 / ord_))


def exact_train_residual(problem: MLFixedPointProblem, X: np.ndarray,
                         inner_steps, gamma: float, ord: float = 2.0,
                         num_batches: int = 1, phase: int = 0) -> float:
    """Exact lifted residual at replica stack ``X`` [p, n]: one
    deterministic application of every worker's map (same minibatch
    schedule, rotation phase ``phase``) from the fresh average — the
    ground truth a synchronized eval would compute, and exactly what
    NFAIS2's verifier evaluates on device.  ``num_batches=1`` is the
    full-batch special case."""
    X = np.asarray(X, dtype=np.float64)
    p = X.shape[0]
    inner = np.broadcast_to(np.asarray(inner_steps, np.int64), (p,))
    shards = _shard_rows(problem, p)
    m_loc = problem.m // p
    if m_loc % num_batches:
        raise ValueError(f"local rows {m_loc} not divisible by "
                         f"num_batches={num_batches}")
    mb = m_loc // num_batches
    mean = X.mean(axis=0)
    total = 0.0 if not np.isinf(ord) else -np.inf
    for i in range(p):
        A_loc, y_loc = shards[i]
        xi = mean.copy()
        s = int(inner[i])
        for t in range(s):
            b = (phase * s + t) % num_batches
            rows = A_loc[b * mb:(b + 1) * mb]
            tgt = y_loc[b * mb:(b + 1) * mb]
            xi = xi - gamma * _np_grad(rows, tgt, xi, problem.task,
                                       problem.l2)
        c = _np_contrib(xi - X[i], ord)
        total = max(total, c) if np.isinf(ord) else total + c
    return _np_sigma(total, ord)


def reference_trace(problem: MLFixedPointProblem, p: int,
                    inner_steps, num_batches: int, gamma: float,
                    rounds: int, ord: float = 2.0):
    """Synchronous (zero-delay) trajectory of the same map, minibatch
    rotation included: returns ``(X_final, residuals[rounds])`` where
    entry k is the monitored residual σ(Σ_i ‖T_i(X_k) − x_i‖^l) the
    blocking device run reproduces round for round."""
    inner = np.broadcast_to(np.asarray(inner_steps, np.int64), (p,))
    shards = _shard_rows(problem, p)
    m_loc = problem.m // p
    if m_loc % num_batches:
        raise ValueError(f"local rows {m_loc} not divisible by "
                         f"num_batches={num_batches}")
    mb = m_loc // num_batches
    X = np.zeros((p, problem.n))
    out = np.empty(rounds)
    for k in range(rounds):
        mean = X.mean(axis=0)
        X_new = np.empty_like(X)
        total = 0.0 if not np.isinf(ord) else -np.inf
        for i in range(p):
            A_loc, y_loc = shards[i]
            xi = mean.copy()
            s = int(inner[i])
            for t in range(s):
                b = (k * s + t) % num_batches
                rows = A_loc[b * mb:(b + 1) * mb]
                tgt = y_loc[b * mb:(b + 1) * mb]
                xi = xi - gamma * _np_grad(rows, tgt, xi, problem.task,
                                           problem.l2)
            X_new[i] = xi
            c = _np_contrib(xi - X[i], ord)
            total = max(total, c) if np.isinf(ord) else total + c
        out[k] = _np_sigma(total, ord)
        X = X_new
    return X, out
