"""ML fixed-point problem family: gradient descent as the paper's iterative
process.

On a strongly convex objective F the map ``f(x) = x − γ ∇F(x)`` is a
contraction for γ < 2/L (L the gradient's Lipschitz constant); its fixed
point is the empirical risk minimiser, and the natural residual is the
update difference ``f(x) − x = −γ∇F(x)``.  Two tasks, on synthetic data
with a planted model:

* ``lstsq``    — ridge least squares, F(x) = ‖Ax−y‖²/(2m) + λ‖x‖²/2, whose
  gradient ``Hx − c`` (H = AᵀA/m + λI) is affine;
* ``logistic`` — ℓ2-regularised logistic regression,
  F(x) = Σ softplus(−s_k·a_kᵀx)/m + λ‖x‖²/2, s ∈ {−1, +1}.

This is the port's own copy of the JAX package's data draw
(``solvers/mlfixed.py``): the same ``np.random.default_rng(seed)`` calls in
the same order, so the same seed gives the same ``A``, ``H``, ``c``, ``s``,
``L`` and ``γ``.  Only the device-facing part is here — the batched step of
the detection lanes, the exact residual that scores them, and the data and
objective the data-parallel training runtime (``runtime/train_async.py``)
reads; the event-level interface (per-worker views and updates) is not.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _sigmoid(z: np.ndarray) -> np.ndarray:
    # numerically stable logistic function (no overflow for |z| large)
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


class MLFixedPointProblem:
    """Gradient descent on a strongly convex ML objective."""

    TASKS = ("lstsq", "logistic")

    def __init__(
        self,
        n: int = 32,
        p: int = 4,
        m_rows: int = 192,
        task: str = "lstsq",
        gamma: float = None,
        l2: float = 1e-2,
        cond: float = 20.0,
        noise: float = 0.05,
        ord: float = 2.0,
        seed: int = 0,
    ):
        if n % p:
            raise ValueError(f"n={n} not divisible by p={p}")
        if task not in self.TASKS:
            raise ValueError(f"task {task!r} not in {self.TASKS}")
        if m_rows < n:
            raise ValueError(f"m_rows={m_rows} < n={n}: need an "
                             "overdetermined design for a unique minimiser")
        if l2 < 0.0:
            raise ValueError(f"l2={l2} must be >= 0")
        if cond < 1.0:
            raise ValueError(f"cond={cond} must be >= 1")
        self.n = n
        self.p = p
        self.m = m_rows
        self.task = task
        self.l2 = float(l2)
        self.ord = float(ord)
        self.block = n // p
        rng = np.random.default_rng(seed)

        # design matrix with controlled conditioning: Gaussian columns
        # scaled geometrically so eig(AᵀA/m) spans ~cond² before the ridge
        col_scale = cond ** (-np.arange(n) / max(n - 1, 1))
        self.A = rng.standard_normal((m_rows, n)) * col_scale
        self.x_true = rng.standard_normal(n)
        z = self.A @ self.x_true
        if task == "lstsq":
            self.y = z + noise * rng.standard_normal(m_rows)
            self.H = self.A.T @ self.A / m_rows + self.l2 * np.eye(n)
            self.c = self.A.T @ self.y / m_rows
            ev = np.linalg.eigvalsh(self.H)
            self.L = float(ev[-1])
            self.mu = float(ev[0])
        else:
            # planted labels s ∈ {−1,+1}; Bernoulli flips keep the problem
            # realisable but not separable
            prob1 = _sigmoid(z)
            self.s = np.where(rng.random(m_rows) < prob1, 1.0, -1.0)
            self.y = self.s
            # L = eigmax(AᵀA)/(4m) + λ (logistic curvature bound σ' ≤ 1/4)
            sv = np.linalg.svd(self.A, compute_uv=False)[0]
            self.L = float(sv * sv / (4.0 * m_rows) + self.l2)
            self.mu = self.l2
        if gamma is None:
            gamma = 1.0 / self.L     # safe step: contraction factor 1 − μ/L
        if not 0.0 < gamma * self.L < 2.0:
            raise ValueError(
                f"gamma={gamma:g} outside the contraction range "
                f"(0, 2/L) = (0, {2.0 / self.L:g})")
        self.gamma = float(gamma)

    def grad(self, x: np.ndarray) -> np.ndarray:
        """Full gradient ∇F(x) (f64, the oracle path)."""
        if self.task == "lstsq":
            return self.H @ x - self.c
        margin = self.s * (self.A @ x)
        w = -self.s * _sigmoid(-margin)
        return self.A.T @ w / self.m + self.l2 * x

    def objective(self, x: np.ndarray) -> float:
        """F(x) (f64): the objective the training runtime minimises."""
        if self.task == "lstsq":
            r = self.A @ x - self.y
            return float(r @ r / (2 * self.m) + self.l2 * (x @ x) / 2)
        margin = self.s * (self.A @ x)
        return float(np.logaddexp(0.0, -margin).sum() / self.m
                     + self.l2 * (x @ x) / 2)

    def assemble(self, xs: Sequence[np.ndarray]) -> np.ndarray:
        return np.concatenate(list(xs))

    def exact_residual(self, xs: Sequence[np.ndarray]) -> float:
        """σ-reduced norm of the update difference −γ∇F(x̄) (f64)."""
        r = -self.gamma * self.grad(self.assemble(xs))
        if np.isinf(self.ord):
            return float(np.max(np.abs(r)))
        if self.ord == 1.0:
            return float(np.abs(r).sum())
        return float(np.sum(np.abs(r) ** self.ord) ** (1.0 / self.ord))

    # -- batched device path (the detection lanes) ---------------------------
    def update_with_residual_batched(self, X: torch.Tensor, H=None, c=None, A=None,
                                     s=None, gamma=None):
        """One synchronous gradient step of every lane, with each lane's
        pre-step residual contribution.

        ``X`` — ``[B, n]`` lane states.  Per-lane operands are stacked:
        lstsq ``H`` ``[B, n, n]`` and ``c`` ``[B, n]``, logistic ``A``
        ``[B, m, n]`` and ``s`` ``[B, m]``, and ``gamma`` ``[B]``; 2-D
        operators and a scalar γ are shared by every lane (this instance's
        by default).  The products are library products (``torch.mm`` /
        ``torch.bmm``), as the JAX package's are plain ``jnp`` products.
        The contribution is reduced from ``R = −γG`` itself (max|R| for l∞,
        Σ|R|^l otherwise), not from ``Y − X``, whose f32 difference would
        drop R's low bits near convergence.  Returns ``(Y, contrib[B])``.
        """
        def lanes(v, default):
            return torch.as_tensor(default if v is None else v, dtype=X.dtype,
                                   device=X.device)

        def matvec(M, v):   # M [B, r, k] or [r, k], v [B, k] -> [B, r]
            if M.dim() == 2:
                return v @ M.T
            return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)

        g = self.gamma if gamma is None else lanes(gamma, None)
        if isinstance(g, torch.Tensor) and g.dim():
            g = g.unsqueeze(-1)
        if self.task == "lstsq":
            G = matvec(lanes(H, self.H), X) - lanes(c, self.c)
        else:
            A, s = lanes(A, self.A), lanes(s, self.s)
            Z = matvec(A, X)
            W = -s * torch.sigmoid(-s * Z)
            WA = W @ A if A.dim() == 2 else torch.bmm(W.unsqueeze(1), A).squeeze(1)
            G = WA / self.m + self.l2 * X
        R = -g * G
        Y = X + R
        if np.isinf(self.ord):
            contrib = R.abs().amax(dim=-1)
        else:
            contrib = (R.abs() ** self.ord).sum(dim=-1)
        return Y, contrib

    def lane_x0(self) -> np.ndarray:
        """Initial state of one detection-service lane (f32 zeros)."""
        return np.zeros((self.n,), np.float32)

    def lane_operands(self) -> dict:
        """This instance's per-lane operands for the batched step: the
        seeded data (f32) and its own safe step γ.  ``m_rows`` and ``l2``
        are shape-bucket constants shared from any instance."""
        if self.task == "lstsq":
            return {"H": np.asarray(self.H, np.float32),
                    "c": np.asarray(self.c, np.float32),
                    "gamma": np.float32(self.gamma)}
        return {"A": np.asarray(self.A, np.float32),
                "s": np.asarray(self.s, np.float32),
                "gamma": np.float32(self.gamma)}
