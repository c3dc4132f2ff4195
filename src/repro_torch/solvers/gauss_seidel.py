"""Red-black Gauss–Seidel sweep — plain PyTorch, globally-aligned checkerboard.

Ghost planes stay frozen during the sweep, so interface nodes relax
Jacobi-style against the last received neighbour data while interior nodes
see same-sweep updates — the paper's hybrid relaxation (§4.1)."""
from __future__ import annotations

import torch

from repro_torch.solvers.convdiff import Stencil
from repro_torch.solvers.jacobi import offdiag_apply


def parity_mask(shape, ox: int, oy: int, oz: int = 0, device=None) -> torch.Tensor:
    """``(ix + iy + iz) mod 2`` over a block at global offsets (ox, oy, oz)."""
    bx, by, bz = shape
    ix = torch.arange(bx, device=device)[:, None, None] + ox
    iy = torch.arange(by, device=device)[None, :, None] + oy
    iz = torch.arange(bz, device=device)[None, None, :] + oz
    return (ix + iy + iz) % 2


def redblack_gs_sweep(st: Stencil, g: torch.Tensor, b: torch.Tensor,
                      ox: int, oy: int, oz: int = 0) -> torch.Tensor:
    """One red-black GS sweep on a ghosted block; returns the new interior.
    ``ox, oy, oz`` are global offsets aligning the checkerboard across
    subdomains."""
    new, _ = redblack_gs_sweep_residual(st, g, b, ox, oy, oz)
    return new


def redblack_gs_sweep_residual(st: Stencil, g: torch.Tensor, b: torch.Tensor,
                               ox: int, oy: int, oz: int = 0):
    """Fused hybrid sweep + pre-sweep residual.

    The first colour's off-diagonal apply doubles as the residual term:
    returns ``(new_interior, r)`` with ``r = b − A x_in`` (residual of the
    *input* state).  ``g`` is not modified.
    """
    parity = parity_mask(b.shape, ox, oy, oz, device=b.device)
    inner = g[1:-1, 1:-1, 1:-1]
    off0 = offdiag_apply(st, g)
    r = b - (st.diag * inner + off0)
    # colour 0 (even parity): Jacobi update against the frozen view
    upd0 = torch.where(parity == 0, (b - off0) / st.diag, inner)
    # colour 1 (odd): sees same-sweep colour-0 values + frozen ghosts
    g2 = g.clone()
    g2[1:-1, 1:-1, 1:-1] = upd0
    new1 = (b - offdiag_apply(st, g2)) / st.diag
    return torch.where(parity == 1, new1, upd0), r
