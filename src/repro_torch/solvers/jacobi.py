"""Jacobi relaxation sweeps — plain PyTorch (the solvers' reference path and
the plain version the jacobi3d CUDA kernel is held against)."""
from __future__ import annotations

import torch

from repro_torch.solvers.convdiff import Stencil


def offdiag_apply(st: Stencil, g: torch.Tensor) -> torch.Tensor:
    """Σ_offdiag a_ij x_j over a ghosted block g[(bx+2, by+2, bz+2)]."""
    return (
        st.xm * g[:-2, 1:-1, 1:-1]
        + st.xp * g[2:, 1:-1, 1:-1]
        + st.ym * g[1:-1, :-2, 1:-1]
        + st.yp * g[1:-1, 2:, 1:-1]
        + st.zm * g[1:-1, 1:-1, :-2]
        + st.zp * g[1:-1, 1:-1, 2:]
    )


def jacobi_sweep(st: Stencil, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One Jacobi sweep; returns the new interior block."""
    return (b - offdiag_apply(st, g)) / st.diag


def jacobi_sweep_residual(st: Stencil, g: torch.Tensor, b: torch.Tensor):
    """Fused sweep + pre-sweep residual, sharing the off-diagonal apply.

    Returns ``(new_interior, r)`` with ``r = b − A x_in`` — the residual of
    the *input* state, the free by-product of the relaxation."""
    off = offdiag_apply(st, g)
    r = b - (st.diag * g[1:-1, 1:-1, 1:-1] + off)
    return (b - off) / st.diag, r


def residual_block(st: Stencil, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b − A x over the rows owned by the ghosted block."""
    return b - (st.diag * g[1:-1, 1:-1, 1:-1] + offdiag_apply(st, g))
