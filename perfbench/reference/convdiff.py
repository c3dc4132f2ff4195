"""Plain PyTorch reference of the convection–diffusion shard solve.

The same semantics as the program's 1-D stacked shard loop, written again
from the paper's description and nothing of the program: the n³ grid is
split into ``p`` x-pencils of ``n / p`` planes; an outer iteration gives
shard i ``inner[i]`` Jacobi sweeps against the x-face ghosts of the
exchange ``halo_delay[i]`` outer iterations old (y and z faces are the
zero boundary), then exchanges faces.  The reduction of outer iteration k
is the sum over shards of their contributions ``contrib_lag[i]`` checks
old:

* ``nonblocking`` — a shard's contribution is Σ(diag·Δ)² of its last
  sweep's update Δ, the monitor sees the reduction of check k − K at
  check k (+∞ before), and PFAIT stops when that value is under ε;
* ``blocking`` — after all sweeps and the exchange, the contribution is
  Σr² of the exact residual r = b − A·x over the fresh faces (worked out
  as diag times one more sweep's update), seen at the same check.

The pencils live in ghosted tensors ``G[p, bx + 2, n + 2, n + 2]``, and
a sweep is six whole-grid elementwise operations,
x' = b / diag − Σ (w / diag) · x_neighbour, from one such tensor into
another."""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Coefs(NamedTuple):
    """The 7-point stencil: ``diag`` and the six off-diagonal weights."""

    diag: float
    xm: float
    xp: float
    ym: float
    yp: float
    zm: float
    zp: float


def coefficients(n: int, nu: float, a: Sequence[float], rho: float) -> Coefs:
    """Backward Euler plus centred differences on the n³ interior of
    [0, 1]³, with the time step chosen so that 6ν/h² / diag = ρ."""
    h = 1.0 / (n + 1)
    d = nu / h ** 2
    inv_dt = 6.0 * d * (1.0 - rho) / rho
    cx, cy, cz = (float(ai) / (2 * h) for ai in a)
    return Coefs(inv_dt + 6.0 * d, -d - cx, -d + cx, -d - cy, -d + cy, -d - cz, -d + cz)


class Solve(NamedTuple):
    """What a solve returns: the state, the outer iterations run, whether
    the monitor fired, and σ of each check's reduction (f32)."""

    x: torch.Tensor
    outer: int
    converged: bool
    trace: np.ndarray


def _residual(G: torch.Tensor, b: torch.Tensor, c: Coefs) -> torch.Tensor:
    """r = b − A·x of every pencil, from its ghosted block."""
    x = G[:, 1:-1, 1:-1, 1:-1]
    r = torch.sub(b, x, alpha=c.diag)
    for nb, w in _neighbours(G, c):
        r.sub_(nb, alpha=w)
    return r


def _neighbours(G: torch.Tensor, c: Coefs):
    """The six neighbour views of every pencil's cells, with their weights."""
    return ((G[:, :-2, 1:-1, 1:-1], c.xm), (G[:, 2:, 1:-1, 1:-1], c.xp),
            (G[:, 1:-1, :-2, 1:-1], c.ym), (G[:, 1:-1, 2:, 1:-1], c.yp),
            (G[:, 1:-1, 1:-1, :-2], c.zm), (G[:, 1:-1, 1:-1, 2:], c.zp))


def _sumsq(a: torch.Tensor, b: torch.Tensor, chunk: int = 16) -> np.ndarray:
    """Σ(a − b)² of each pencil in f64, a few pencils at a time."""
    out = [torch.linalg.vector_norm(a[i:i + chunk] - b[i:i + chunk], dim=(1, 2, 3),
                                    dtype=torch.float64).square()
           for i in range(0, a.shape[0], chunk)]
    return torch.cat(out).cpu().numpy()


def _sweep(G: torch.Tensor, out: torch.Tensor, bd: torch.Tensor, c: Coefs) -> None:
    """One Jacobi sweep of every pencil into ``out``:
    x' = b / diag − Σ (w / diag) · x_neighbour."""
    (first, w0), *rest = _neighbours(G, c)
    torch.sub(bd, first, alpha=w0 / c.diag, out=out)
    for nb, w in rest:
        out.sub_(nb, alpha=w / c.diag)


def _faces(G: torch.Tensor):
    """The exchange: each pencil's first and last planes (copies)."""
    return G[:, 1, 1:-1, 1:-1].clone(), G[:, -2, 1:-1, 1:-1].clone()


def _set_ghosts(G: torch.Tensor, ring: list, k: int, delay: np.ndarray) -> None:
    """Fill pencil i's x ghosts from exchange ``max(k − delay[i], 0)``:
    its minus ghost is pencil i−1's last plane, its plus ghost pencil
    i+1's first plane; the ends keep the zero boundary."""
    p = G.shape[0]
    for d in np.unique(delay):
        first, last = ring[max(k - int(d), 0) % len(ring)]
        idx = np.flatnonzero(delay == d)
        lo = idx[idx > 0]
        hi = idx[idx < p - 1]
        if lo.size:
            G[torch.as_tensor(lo), 0, 1:-1, 1:-1] = last[torch.as_tensor(lo - 1)]
        if hi.size:
            G[torch.as_tensor(hi), -1, 1:-1, 1:-1] = first[torch.as_tensor(hi + 1)]


def _per_shard(v, p: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(v, dtype=np.int64), (p,)).copy()


def solve(b: torch.Tensor, x0: Optional[torch.Tensor], c: Coefs, p: int, *, reduction: str,
          staleness: int, eps: float, inner, halo_delay=0, contrib_lag=0,
          max_outer: int) -> Solve:
    """Run the shard solve on ``b`` from ``x0`` (both (n, n, n); None: 0),
    in b's dtype, on its device, until the monitor fires or
    ``max_outer``.  The state returned is a view [p, n / p, n, n] into the
    solve's buffer; b is not kept."""
    if reduction not in ("nonblocking", "blocking"):
        raise ValueError(f"the reference runs nonblocking or blocking, not {reduction!r}")
    n = b.shape[0]
    if n % p:
        raise ValueError(f"n={n} not divisible by p={p}")
    bx = n // p
    inner, delay, lag = (_per_shard(v, p) for v in (inner, halo_delay, contrib_lag))
    blocking = reduction == "blocking"
    K = 0 if blocking else int(staleness)
    # two ghosted buffers: a sweep reads one and writes the other
    G, Gn = (torch.zeros((p, bx + 2, n + 2, n + 2), dtype=b.dtype, device=b.device)
             for _ in range(2))
    if x0 is not None:
        G[:, 1:-1, 1:-1, 1:-1] = x0.reshape(p, bx, n, n)
    bd = b.reshape(p, bx, n, n) / c.diag
    del b
    ring = [_faces(G)] * (int(delay.max()) + 1)
    lanes = np.zeros((int(lag.max()) + 1, p))
    eps32 = np.float32(eps)
    trace, k, converged = [], 0, False
    while k < max_outer:
        _set_ghosts(G, ring, k, delay)
        _set_ghosts(Gn, ring, k, delay)
        contrib = np.zeros(p)
        for s in range(int(inner.max())):
            x, new = G[:, 1:-1, 1:-1, 1:-1], Gn[:, 1:-1, 1:-1, 1:-1]
            _sweep(G, new, bd, c)
            last = (s == inner - 1) & (not blocking)
            if last.any():
                sel = slice(None) if last.all() else torch.as_tensor(np.flatnonzero(last))
                contrib[last] = _sumsq(new[sel], x[sel]) * c.diag ** 2
            keep = s >= inner
            if keep.any():
                sel = torch.as_tensor(np.flatnonzero(keep))
                new[sel] = x[sel]
            G, Gn = Gn, G
        ring[(k + 1) % len(ring)] = _faces(G)
        if blocking:
            # r / diag = x' − x for a sweep over the fresh faces
            _set_ghosts(G, ring, k + 1, delay)
            _set_ghosts(Gn, ring, k + 1, delay)
            _sweep(G, Gn[:, 1:-1, 1:-1, 1:-1], bd, c)
            contrib = _sumsq(Gn[:, 1:-1, 1:-1, 1:-1], G[:, 1:-1, 1:-1, 1:-1]) * c.diag ** 2
        lanes[k % len(lanes)] = contrib
        seen = np.array([lanes[max(k - int(lag[i]), 0) % len(lanes)][i] for i in range(p)])
        trace.append(np.float32(np.sqrt(seen.sum())))
        k += 1
        if k - 1 >= K and trace[k - 1 - K] < eps32:
            converged = True
            break
    del Gn
    return Solve(G[:, 1:-1, 1:-1, 1:-1], k, converged, np.array(trace, dtype=np.float32))


def exact_residual(x: torch.Tensor, b: torch.Tensor, c: Coefs) -> float:
    """‖b − A·x‖₂ over the whole grid with zero Dirichlet faces, in f64,
    in slabs of planes so that it fits beside the state."""
    n = x.shape[0]
    total = 0.0
    step = max(1, n // 16)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        g = torch.zeros((hi - lo + 2, n + 2, n + 2), dtype=torch.float64, device=x.device)
        g[1:-1, 1:-1, 1:-1] = x[lo:hi]
        if lo > 0:
            g[0, 1:-1, 1:-1] = x[lo - 1]
        if hi < n:
            g[-1, 1:-1, 1:-1] = x[hi]
        r = _residual(g[None], b[lo:hi].to(torch.float64)[None], c)
        total += float(r.square().sum())
        del g, r
    return float(np.sqrt(total))
