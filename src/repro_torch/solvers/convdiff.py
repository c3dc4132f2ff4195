"""3-D convection–diffusion problem (paper §4.1).

    ∂u/∂t − ν Δu + a·∇u = s   on [0,1]³, homogeneous Dirichlet BC.

Backward-Euler + centred finite differences give, per time step, a sparse
linear system ``A x = b`` with the 7-point stencil

    diag       : 1/dt + 6ν/h²
    x∓ /y∓ /z∓ : −ν/h² ∓ a_d/(2h)      (d = x, y, z)

solved by relaxation.  The Jacobi iteration matrix has spectral radius
ρ ≈ (6ν/h²)/(1/dt + 6ν/h²) < 1, so ``dt`` controls the contraction rate;
``for_contraction`` picks dt for a target ρ.

``ConvDiffProblem`` is the device-facing part of the JAX package's problem
class: its geometry and seeded rhs, and the batched step of the detection
lanes (``update_with_residual_batched``, ``lane_x0``, ``lane_operands``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.solvers.partition import GridPartition, process_grid


@dataclass(frozen=True)
class Stencil:
    """7-point convection–diffusion stencil coefficients."""

    diag: float
    xm: float
    xp: float
    ym: float
    yp: float
    zm: float
    zp: float

    @staticmethod
    def convdiff(n: int, nu: float, a: Tuple[float, float, float], dt: float) -> "Stencil":
        h = 1.0 / (n + 1)
        d = nu / h**2
        cx, cy, cz = (ai / (2 * h) for ai in a)
        return Stencil(
            diag=1.0 / dt + 6.0 * d,
            xm=-d - cx, xp=-d + cx,
            ym=-d - cy, yp=-d + cy,
            zm=-d - cz, zp=-d + cz,
        )

    @staticmethod
    def for_contraction(n: int, nu: float, a: Tuple[float, float, float], rho: float) -> "Stencil":
        """Pick dt so the Jacobi spectral-radius proxy 6ν/h² / diag = rho."""
        h = 1.0 / (n + 1)
        d = nu / h**2
        inv_dt = 6.0 * d * (1.0 - rho) / rho
        return Stencil.convdiff(n, nu, a, dt=1.0 / inv_dt)

    @property
    def coefs(self) -> Tuple[float, ...]:
        """``(diag, xm, xp, ym, yp, zm, zp)`` — the kernels' coefficient order."""
        return (self.diag, self.xm, self.xp, self.ym, self.yp, self.zm, self.zp)


def make_rhs(n: int, seed: int = 0, kind: str = "smooth") -> np.ndarray:
    """Right-hand side b = u_prev/dt + s on the n³ interior grid (numpy, so
    both packages make the same ``b`` from a seed)."""
    if kind == "const":
        return np.ones((n, n, n))
    rng = np.random.default_rng(seed)
    xs = np.linspace(0, 1, n + 2)[1:-1]
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    b = (
        np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
        + 0.3 * np.sin(2 * np.pi * X) * np.cos(np.pi * Z)
    )
    return b + 0.05 * rng.standard_normal((n, n, n))


class ConvDiffProblem:
    """The paper's experiment: an ``n³`` grid over a ``p``-worker process
    grid (validated as the JAX package's), the stencil for a contraction
    ``rho`` and the rhs of ``seed``."""

    def __init__(
        self,
        n: int = 24,
        p: int = 4,
        nu: float = 1.0,
        a: Tuple[float, float, float] = (1.0, 1.0, 1.0),
        rho: float = 0.95,
        ord: float = float("inf"),
        seed: int = 0,
        sweep: str = "hybrid",  # "hybrid" (paper: GS interior) | "jacobi"
    ):
        if sweep not in ("jacobi", "hybrid"):
            raise ValueError(f"sweep {sweep!r} not in ('jacobi', 'hybrid')")
        px, py = process_grid(p)
        self.part = GridPartition(n=n, px=px, py=py)
        self.p = self.part.p
        self.n = n
        self.ord = ord
        self.sweep = sweep
        self.st = Stencil.for_contraction(n, nu, a, rho)
        self.b_global = make_rhs(n, seed)

    def update_with_residual_batched(self, X: torch.Tensor, b=None):
        """One synchronous global sweep of every lane, with the residual
        contribution of each lane's *input* state.

        ``X`` — ``[B, n, n, n]`` lane states; ``b`` — the rhs, ``[n, n, n]``
        or one per lane ``[B, n, n, n]`` (this instance's by default).  Each
        lane is zero-padded (Dirichlet) and swept by one launch of the
        Jacobi kernel (``sweep="jacobi"``) or of the hybrid red-black GS
        kernel at phase 0 (``sweep="hybrid"``), whose output is the lane's
        row of ``X_next``; its partials reduce to the contribution (max|r|
        for l∞, Σr² for l2, Σ|r| for l1).  CPU tensors take the kernels'
        plain versions, CUDA tensors launch the kernels or raise.  Returns
        ``(X_next, contrib[B])``.
        """
        # function-level imports: the kernel modules import this one
        from repro_torch.kernels.jacobi3d.jacobi3d import (
            fused_rbgs_sweep_residual,
            fused_sweep_residual,
        )
        from repro_torch.kernels.jacobi3d.ops import _reduce

        b = torch.as_tensor(self.b_global if b is None else b, dtype=X.dtype,
                            device=X.device)
        coefs = self.st.coefs
        news, contribs = [], []
        for i in range(X.shape[0]):
            bi = (b[i] if b.dim() == 4 else b).contiguous()
            if self.sweep == "jacobi":
                new, parts = fused_sweep_residual(F.pad(X[i], (1,) * 6), bi, coefs,
                                                  op="sweep", ord=self.ord)
            else:
                new, parts = fused_rbgs_sweep_residual(
                    F.pad(X[i], (1, 1, 2, 2, 2, 2)), bi, coefs, 0, ord=self.ord)
            news.append(new)
            contribs.append(_reduce(parts, self.ord))
        return torch.stack(news), torch.stack(contribs)

    def lane_x0(self) -> np.ndarray:
        """Initial state of one detection-service lane (f32 zeros)."""
        return np.zeros((self.n, self.n, self.n), np.float32)

    def lane_operands(self) -> dict:
        """This instance's per-lane operands for the batched step: its rhs
        (f32).  The stencil is geometry, shared by every instance of a
        shape bucket."""
        return {"b": np.asarray(self.b_global, np.float32)}
