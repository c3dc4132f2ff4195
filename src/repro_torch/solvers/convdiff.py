"""3-D convection–diffusion problem (paper §4.1).

    ∂u/∂t − ν Δu + a·∇u = s   on [0,1]³, homogeneous Dirichlet BC.

Backward-Euler + centred finite differences give, per time step, a sparse
linear system ``A x = b`` with the 7-point stencil

    diag       : 1/dt + 6ν/h²
    x∓ /y∓ /z∓ : −ν/h² ∓ a_d/(2h)      (d = x, y, z)

solved by relaxation.  The Jacobi iteration matrix has spectral radius
ρ ≈ (6ν/h²)/(1/dt + 6ν/h²) < 1, so ``dt`` controls the contraction rate;
``for_contraction`` picks dt for a target ρ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


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
