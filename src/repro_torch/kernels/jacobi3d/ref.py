"""Plain PyTorch versions of the jacobi3d kernels (same inputs, same outputs).

The CPU path of every wrapper in ``jacobi3d.py`` and what the CUDA kernels
are held against on the card."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.residual import L1, LINF, partial_mode
from repro_torch.solvers import gauss_seidel, jacobi
from repro_torch.solvers.convdiff import Stencil

INF = float("inf")

#: (tx, ty) column tile of the (x, y) plane.  On the H100 the kernels run
#: one 256-thread block per tile; (4, 8) gives 47 × 24 = 1128 blocks at a
#: 185² plane and 7 × 19 = 133 at a 25 × 150 shard plane, so every one of
#: the 132 SMs gets work (the TPU's (8, 128) gives 24 × 2 = 48 at 185²).
DEFAULT_TILE: Tuple[int, int] = (4, 8)


def tile_grid(bx: int, by: int, tile: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """``(tx, ty, nx, ny)``: the tile clipped to the block and the number of
    tiles per axis (a ragged last tile counts as one)."""
    if min(tile) < 1:
        raise ValueError(f"tile {tile} must be positive")
    tx, ty = min(tile[0], bx), min(tile[1], by)
    return tx, ty, -(-bx // tx), -(-by // ty)


def residual_partials(r: torch.Tensor, tile: Tuple[int, int] = DEFAULT_TILE,
                      ord: float = INF) -> torch.Tensor:
    """Per-(x,y)-tile f32 partials of a residual block, ``[nx, ny]``, for
    the norm order ``ord``: ``max|r|`` (∞), ``Σr²`` squared in r's type and
    then cast (2), or ``Σ|r|`` cast and then summed (1, as
    ``core.residual.local_contribution``).  A ragged edge tile covers what
    is left of the block."""
    mode = partial_mode(ord)
    bx, by, bz = r.shape
    tx, ty, nx, ny = tile_grid(bx, by, tile)
    rp = F.pad(r, (0, 0, 0, ny * ty - by, 0, nx * tx - bx))  # zeros change no partial
    rt = rp.reshape(nx, tx, ny, ty, bz)
    if mode == LINF:
        return rt.abs().amax(dim=(1, 3, 4)).to(torch.float32)
    if mode == L1:
        return rt.to(torch.float32).abs().sum(dim=(1, 3, 4))
    return (rt * rt).to(torch.float32).sum(dim=(1, 3, 4))


def fused_sweep_residual_ref(g: torch.Tensor, b: torch.Tensor,
                             coefs: Sequence[float],
                             tile: Tuple[int, int] = DEFAULT_TILE,
                             op: str = "sweep", ord: float = INF):
    """Jacobi sweep (``op="sweep"``) or the unchanged field
    (``op="residual"``) of a ±1 ghosted block, with the input state's
    residual partials."""
    st = Stencil(*coefs)
    if op == "sweep":
        new, r = jacobi.jacobi_sweep_residual(st, g, b)
    else:
        new, r = g[1:-1, 1:-1, 1:-1], jacobi.residual_block(st, g, b)
    return new, residual_partials(r, tile=tile, ord=ord)


def fused_rbgs_sweep_residual_ref(g2: torch.Tensor, b: torch.Tensor,
                                  coefs: Sequence[float], oxy: int,
                                  tile: Tuple[int, int] = DEFAULT_TILE,
                                  ord: float = INF):
    """Hybrid red-black GS sweep of a twice-padded block (``ghost_pad2``
    layout) with the input state's residual partials: the ±1 ghosted block
    is ``g2[1:-1, 1:-1]``, and the checkerboard phase is ``oxy = ox + oy``."""
    new, r = gauss_seidel.redblack_gs_sweep_residual(
        Stencil(*coefs), g2[1:-1, 1:-1], b, oxy, 0)
    return new, residual_partials(r, tile=tile, ord=ord)


def _ghosted6(x: torch.Tensor, halos) -> torch.Tensor:
    # function-level import: fixed_point imports the kernel ops, which
    # import this module
    from repro_torch.solvers.fixed_point import ghosted6

    return ghosted6(x, halos)


def fused_sweep_residual_halo_ref(x: torch.Tensor, halos, b: torch.Tensor,
                                  coefs: Sequence[float],
                                  tile: Tuple[int, int] = DEFAULT_TILE,
                                  op: str = "sweep", ord: float = INF):
    """Jacobi sweep (or the unchanged field) of an unghosted block and its
    six face planes ``(gxm, gxp, gym, gyp, gzm, gzp)``, with the input
    state's residual partials: ``ghosted6`` then the ghosted version."""
    return fused_sweep_residual_ref(_ghosted6(x, halos), b, coefs, tile=tile,
                                    op=op, ord=ord)


def fused_rbgs_sweep_residual_halo_ref(x: torch.Tensor, halos, b: torch.Tensor,
                                       coefs: Sequence[float], oxyz: int,
                                       tile: Tuple[int, int] = DEFAULT_TILE,
                                       ord: float = INF):
    """Hybrid red-black GS sweep of an unghosted block and its six face
    planes, with the input state's residual partials; the checkerboard
    phase is ``oxyz = ox + oy + oz``."""
    new, r = gauss_seidel.redblack_gs_sweep_residual(
        Stencil(*coefs), _ghosted6(x, halos), b, oxyz, 0)
    return new, residual_partials(r, tile=tile, ord=ord)
