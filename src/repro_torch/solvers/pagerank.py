"""Damped PageRank / D-iteration fixed point, the paper's second problem family.

    x = d · P x + (1 − d)/n · 1,        0 < d < 1,  P column-stochastic,

decomposed over ``p`` contiguous node blocks.  The random graph is
hub-biased (Zipf-weighted targets), so the block dependency graph is
asymmetric: block 0 feeds everyone while the tail blocks mostly consume.
The iteration contracts in l1 with factor d per sweep, so the natural
residual order is ``ord=1``.

This is the port's own copy of the JAX package's graph draw
(``solvers/pagerank.py``): the same ``np.random.default_rng(seed)`` calls
in the same order, so the same seed gives the same graph.  The dense
operator is built straight from the target lists, ``P[r, j] =
1/|targets_j|``, which is bitwise the JAX package's ``to_dense()``.

The event-level methods the asynchronous engine (``core/async_engine.py``)
calls build the JAX package's block-compressed storage from the same
target lists at their first call and keep it on ``device``: per (dst
block i, src block j) the support of j that i reads and its compressed
operator ``W_ij``, the diagonal block ``A_i``, and the packed per-worker
operator ``[A_i | W_ij …]``, so a sweep is one ``torch.mv`` (a library
product, as the JAX package's is plain numpy) and its contribution
``‖x_new − x_i‖`` one launch of the diff-norm kernel (#5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.residual_norm.residual_norm import diff_norm_partials


def host_blocks(xs) -> np.ndarray:
    """The concatenated global vector on the host: one device→host copy of
    the concatenated tensors (blocks on a device), or numpy's concatenate."""
    if xs and isinstance(xs[0], torch.Tensor):
        return torch.cat(list(xs)).cpu().numpy()
    return np.concatenate(list(xs))


class _BlockStorage:
    """The JAX package's block-compressed storage (``solvers/pagerank.py``,
    its ``__init__``), built from the target lists with the same loops and
    placed on ``device``."""

    def __init__(self, prob: "PageRankProblem", device: torch.device):
        p, blk = prob.p, prob.block
        entries: Dict[tuple, List[tuple]] = {}
        for j, targets in enumerate(prob._cols):
            val = 1.0 / targets.size
            for r in targets:
                entries.setdefault((r // blk, j // blk), []).append(
                    (r % blk, j % blk, val))
        W: List[Dict[int, np.ndarray]] = [dict() for _ in range(p)]
        supp: List[Dict[int, np.ndarray]] = [dict() for _ in range(p)]
        A = [np.zeros((blk, blk)) for _ in range(p)]
        for (bi, bj), es in entries.items():
            if bi == bj:
                for r, c, v in es:
                    A[bi][r, c] += v
                continue
            support = np.unique(np.array([c for _, c, _ in es]))
            pos = {c: k for k, c in enumerate(support)}
            w = np.zeros((blk, support.size))
            for r, c, v in es:
                w[r, pos[c]] += v
            supp[bj].setdefault(bi, support)   # which of j's components i reads
            W[bi][bj] = w
        self.neighbors = []
        for i in range(p):
            nb = set(W[i]) | set(supp[i])
            nb.discard(i)
            self.neighbors.append(sorted(nb))

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.device = device
        self.A = [dev(a) for a in A]
        self.W = [{j: dev(w) for j, w in Wi.items()} for Wi in W]
        self.supp = [{j: dev(s) for j, s in si.items()} for si in supp]
        # the packed operator [A_i | W_ij …] over j in sorted order, the
        # persistent packed input [x_i; deps…] and each neighbour's slot
        self.M, self.buf, self.slots = [], [], []
        for i in range(p):
            js = sorted(W[i])
            self.M.append(dev(np.concatenate([A[i]] + [W[i][j] for j in js], axis=1)))
            slots, pos = [], blk
            for j in js:
                slots.append((j, slice(pos, pos + W[i][j].shape[1])))
                pos += W[i][j].shape[1]
            self.buf.append(torch.empty(pos, dtype=torch.float64, device=device))
            self.slots.append(slots)
        self.empty = torch.empty(0, dtype=torch.float64, device=device)


class PageRankProblem:
    """Damped PageRank over a random hub-biased directed graph.

    The event-level methods keep their blocks on ``device`` (the card
    unless the caller asks for another; resolved at their first call) in
    f64, and count in ``syncs`` every device→host read they make.  Their
    contributions exist for ord 1, 2 and ∞ (the kernel's modes).
    """

    def __init__(
        self,
        n: int = 256,
        p: int = 4,
        damping: float = 0.85,
        avg_deg: float = 6.0,
        hub_skew: float = 0.8,
        ord: float = 1.0,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if n % p:
            raise ValueError(f"n={n} not divisible by p={p}")
        if not 0.0 < damping < 1.0:
            raise ValueError(f"damping={damping} must be in (0, 1)")
        self.n = n
        self.p = p
        self.d = float(damping)
        self.ord = float(ord)
        self.block = n // p
        rng = np.random.default_rng(seed)

        # hub-biased directed graph: targets drawn Zipf-weighted toward
        # low-indexed nodes, so block 0 is everyone's dependency while the
        # tail blocks are mostly read-only consumers (asymmetry)
        w = 1.0 / (np.arange(n) + 1.0) ** hub_skew
        w /= w.sum()
        cols: List[np.ndarray] = []       # per source node: its out-targets
        for j in range(n):
            deg = 1 + int(rng.poisson(max(avg_deg - 1.0, 0.0)))
            deg = min(deg, n - 1)
            targets = rng.choice(n, size=deg, replace=False, p=w)
            targets = targets[targets != j]
            if targets.size == 0:  # no dangling columns: keep P stochastic
                targets = np.array([(j + 1) % n])
            cols.append(np.unique(targets))
        self._cols = cols
        self.v = (1.0 - self.d) / n  # uniform teleport component
        self._P_dense: Optional[np.ndarray] = None  # lazy
        self._device = device
        self._ev: Optional[_BlockStorage] = None
        self.syncs = 0   # device→host reads of the event methods

    # -- event-level methods (core/async_engine.py:DecomposedProblem) ---------
    def _events(self) -> _BlockStorage:
        if self._ev is None:
            self._ev = _BlockStorage(self, resolve_device(self._device))
        return self._ev

    def neighbors(self, i: int) -> List[int]:
        return self._events().neighbors[i]

    def init_local(self, i: int) -> torch.Tensor:
        return torch.full((self.block,), 1.0 / self.n, dtype=torch.float64,
                          device=self._events().device)

    def interface(self, i: int, x_i: torch.Tensor, j: int) -> torch.Tensor:
        """The components of block i that block j reads (a fresh tensor), or
        an empty one where j never reads from i (asymmetric edge)."""
        ev = self._events()
        supp = ev.supp[i].get(j)
        return ev.empty if supp is None else x_i[supp]

    def _apply(self, i: int, x_i: torch.Tensor,
               deps: Dict[int, torch.Tensor]) -> torch.Tensor:
        """f_i(x): d · (row-block of P x) + teleport, one product of the
        packed operator; a partial view (snapshot records mid-round) takes
        the per-neighbour products instead."""
        ev = self._events()
        buf = ev.buf[i]
        buf[:self.block] = x_i
        for j, slot in ev.slots[i]:
            dep = deps.get(j)
            if dep is None:
                break
            buf[slot] = dep
        else:
            return self.d * torch.mv(ev.M[i], buf) + self.v
        y = torch.mv(ev.A[i], x_i)
        for j, W in ev.W[i].items():
            dep = deps.get(j)
            if dep is not None and dep.numel():
                y += torch.mv(W, dep)
        return self.d * y + self.v

    def _contribution(self, x_new: torch.Tensor, x_i: torch.Tensor) -> float:
        """Σ|Δ|^l (l = 1, 2) or max|Δ| of Δ = x_new − x_i: one launch of
        the diff-norm kernel with one partial, read back."""
        parts = diff_norm_partials(x_new, x_i, block=x_new.numel(), ord=self.ord)
        self.syncs += 1
        return float(parts[0])

    def update(self, i: int, x_i: torch.Tensor,
               deps: Dict[int, torch.Tensor]) -> torch.Tensor:
        return self._apply(i, x_i, deps)

    def update_with_residual(self, i: int, x_i: torch.Tensor,
                             deps: Dict[int, torch.Tensor],
                             need_residual: bool = True):
        """Fused sweep + residual: the D-iteration residual is the update
        difference."""
        x_new = self._apply(i, x_i, deps)
        if not need_residual:
            return x_new, None
        return x_new, self._contribution(x_new, x_i)

    def local_residual(self, i: int, x_i: torch.Tensor,
                       deps: Dict[int, torch.Tensor]) -> float:
        return self._contribution(self._apply(i, x_i, deps), x_i)

    def solve_reference(self, tol: float = 1e-14,
                        max_iter: int = 10_000) -> torch.Tensor:
        """Synchronous power iteration to high precision (test oracle)."""
        xs = [self.init_local(i) for i in range(self.p)]
        for _ in range(max_iter):
            deps = [{j: self.interface(j, xs[j], i) for j in self.neighbors(i)}
                    for i in range(self.p)]
            new = [self._apply(i, xs[i], deps[i]) for i in range(self.p)]
            delta = max(float((a - b).abs().max()) for a, b in zip(new, xs))
            xs = new
            if delta < tol:
                break
        return torch.cat(xs)

    def to_dense(self) -> np.ndarray:
        """Dense column-stochastic P, ``P[r, j] = 1/|targets_j|`` (cached)."""
        if self._P_dense is None:
            sizes = np.array([t.size for t in self._cols])
            P = np.zeros((self.n, self.n))
            P[np.concatenate(self._cols), np.repeat(np.arange(self.n), sizes)] = \
                np.repeat(1.0 / sizes, sizes)
            self._P_dense = P
        return self._P_dense

    def assemble(self, xs: Sequence[np.ndarray]) -> np.ndarray:
        """The global vector on the host (numpy) from blocks on any device."""
        return host_blocks(xs)

    def exact_residual(self, xs: Sequence[np.ndarray]) -> float:
        """r(x̄) = ‖d·P x̄ + v − x̄‖_ord in f64, by one dense matvec on the
        host (blocks on a device cost one read, counted in ``syncs``)."""
        if xs and isinstance(xs[0], torch.Tensor):
            self.syncs += 1
        x = self.assemble(xs)
        r = self.d * (self.to_dense() @ x) + self.v - x
        if np.isinf(self.ord):
            return float(np.max(np.abs(r)))
        if self.ord == 1.0:
            return float(np.abs(r).sum())
        return float(np.sum(np.abs(r) ** self.ord) ** (1.0 / self.ord))

    # -- batched device path (the detection lanes) ---------------------------
    def update_with_residual_batched(self, X: torch.Tensor, P=None):
        """One synchronous global D-iteration step of every lane, with each
        lane's pre-step residual contribution.

        ``X`` — ``[B, n]`` lane states; ``P`` — the dense operator, ``[n, n]``
        or one per lane ``[B, n, n]`` (this instance's by default).  ``Y =
        d·P x + v`` is a library product (``torch.mm``/``torch.bmm``), as in
        the JAX package; the contribution of ``R = Y − X`` (Σ|r|^l, max|r|
        for l∞) comes from one launch of the diff-norm kernel over all lanes
        (a partial per lane) for l ∈ {1, 2, ∞}.  Other orders raise on the
        card and are reduced plainly on the CPU.  Returns ``(Y, contrib[B])``.
        """
        P = torch.as_tensor(self.to_dense() if P is None else P, dtype=X.dtype,
                            device=X.device)
        if P.dim() == 2:
            Y = self.d * (X @ P.T) + self.v
        else:
            Y = self.d * torch.bmm(P, X.unsqueeze(-1)).squeeze(-1) + self.v
        if float(self.ord) in (1.0, 2.0, float("inf")) or _build.on_cuda(X, Y):
            contrib = diff_norm_partials(Y, X, block=self.n, ord=self.ord)
        else:
            contrib = ((Y - X).abs() ** self.ord).sum(dim=-1)
        return Y, contrib

    def lane_x0(self) -> np.ndarray:
        """Initial state of one detection-service lane (f32, uniform)."""
        return np.full((self.n,), 1.0 / self.n, np.float32)

    def lane_operands(self) -> dict:
        """This instance's per-lane operands for the batched step: the
        seeded graph's operator (f32).  ``v`` and the damping are shape-
        bucket constants shared from any instance."""
        return {"P": np.asarray(self.to_dense(), np.float32)}
