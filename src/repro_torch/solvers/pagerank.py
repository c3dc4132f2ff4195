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
1/|targets_j|``, which is bitwise the JAX package's ``to_dense()``; the
block-compressed storage the JAX package keeps for its event engine is not
built here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.residual_norm.residual_norm import diff_norm_partials


class PageRankProblem:
    """Damped PageRank over a random hub-biased directed graph."""

    def __init__(
        self,
        n: int = 256,
        p: int = 4,
        damping: float = 0.85,
        avg_deg: float = 6.0,
        hub_skew: float = 0.8,
        ord: float = 1.0,
        seed: int = 0,
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
        return np.concatenate(list(xs))

    def exact_residual(self, xs: Sequence[np.ndarray]) -> float:
        """r(x̄) = ‖d·P x̄ + v − x̄‖_ord in f64, by one dense matvec."""
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
