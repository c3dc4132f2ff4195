"""Wrappers of the fused sweep + residual CUDA kernels (``csrc/jacobi3d.cu``).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches (only
launches — the CPU path does not count), so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DBL, INT, PTR
from repro_torch.kernels.jacobi3d.ref import (
    DEFAULT_TILE,
    fused_rbgs_sweep_residual_ref,
    fused_sweep_residual_ref,
    tile_grid,
)

LAUNCHES: Dict[str, int] = {"fused_sweep_residual": 0,
                            "fused_rbgs_sweep_residual": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# (g, b, out, parts, bx, by, bz, tx, ty, flag, linf, 7 coefs, stream)
_SIG = (PTR,) * 4 + (INT,) * 7 + (DBL,) * 7 + (PTR,)
_SIGNATURES = {f"{k}_{s}": _SIG for k in LAUNCHES for s in _SUFFIX.values()}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _validate(g: torch.Tensor, b: torch.Tensor, pad: Tuple[int, int, int]):
    if b.dim() != 3 or min(b.shape) < 1:
        raise ValueError(f"b must be a non-empty 3-D block, got {tuple(b.shape)}")
    want = tuple(n + p for n, p in zip(b.shape, pad))
    if tuple(g.shape) != want:
        raise ValueError(f"ghosted block has shape {tuple(g.shape)}, want {want}")
    if g.dtype != b.dtype or b.dtype not in _SUFFIX:
        raise TypeError(f"need matching f32/f64 inputs, got {g.dtype}/{b.dtype}")
    if not (g.is_contiguous() and b.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")


def _launch(kernel: str, g, b, out: Optional[torch.Tensor], tile, flag: int,
            linf: bool, coefs: Sequence[float]) -> torch.Tensor:
    bx, by, bz = b.shape
    tx, ty, nx, ny = tile_grid(bx, by, tile)
    parts = torch.empty((nx, ny), dtype=torch.float32, device=b.device)
    fn = getattr(_build.load("jacobi3d", _SIGNATURES), f"{kernel}_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        err = fn(g.data_ptr(), b.data_ptr(),
                 None if out is None else out.data_ptr(), parts.data_ptr(),
                 bx, by, bz, tx, ty, flag, int(linf), *map(float, coefs),
                 torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, kernel)
    LAUNCHES[kernel] += 1
    return parts


def fused_sweep_residual(g: torch.Tensor, b: torch.Tensor,
                         coefs: Sequence[float],
                         tile: Tuple[int, int] = DEFAULT_TILE,
                         op: str = "sweep", linf: bool = True):
    """Jacobi sweep of a ±1 ghosted block ``g[(bx+2),(by+2),(bz+2)]`` with
    the input state's residual partials ``[nx, ny]`` (f32).

    ``coefs`` is ``(diag, xm, xp, ym, yp, zm, zp)``.  ``op="residual"`` is
    the residual-only pass: the kernel writes no block, and the returned
    block is a view of ``g``'s interior.
    """
    if op not in ("sweep", "residual"):
        raise ValueError(f"op {op!r} not in ('sweep', 'residual')")
    if not _build.on_cuda(g, b):
        return fused_sweep_residual_ref(g, b, coefs, tile=tile, op=op, linf=linf)
    _validate(g, b, (2, 2, 2))
    out = torch.empty_like(b) if op == "sweep" else None
    parts = _launch("fused_sweep_residual", g, b, out, tile, int(op == "sweep"),
                    linf, coefs)
    return (g[1:-1, 1:-1, 1:-1] if out is None else out), parts


def fused_rbgs_sweep_residual(g2: torch.Tensor, b: torch.Tensor,
                              coefs: Sequence[float], oxy: int,
                              tile: Tuple[int, int] = DEFAULT_TILE,
                              linf: bool = True):
    """One-pass hybrid red-black GS sweep of a twice-padded block
    ``g2[(bx+4),(by+4),(bz+2)]`` (``ops.ghost_pad2``) with the unpadded rhs
    ``b``, plus the input state's residual partials ``[nx, ny]`` (f32).
    ``oxy = ox + oy`` is the block's global checkerboard phase."""
    if not _build.on_cuda(g2, b):
        return fused_rbgs_sweep_residual_ref(g2, b, coefs, int(oxy), tile=tile,
                                             linf=linf)
    _validate(g2, b, (4, 4, 2))
    out = torch.empty_like(b)
    parts = _launch("fused_rbgs_sweep_residual", g2, b, out, tile, int(oxy),
                    linf, coefs)
    return out, parts
