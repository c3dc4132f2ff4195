"""Wrappers of the fused sweep + residual CUDA kernels: the ghosted-block
sweeps (``csrc/jacobi3d.cu``) and their halo-consuming twins, which take an
unghosted block and six face planes (``csrc/jacobi3d_halo.cu``).

Every wrapper's ``ord`` picks what its residual partials reduce: max|r|
(∞), Σr² (2) or Σ|r| (1); any other order raises.  A tensor on the CPU
goes to the plain version in ``ref.py``; a CUDA tensor launches the kernel
or raises; ``fused_sweep_residual`` on ``meta`` tensors (a dry rank)
computes nothing and reports its ``work``, as it does at every launch.
``LAUNCHES`` counts kernel launches (only launches — the CPU path does not
count), so a run can show that its main path went through the kernels;
``LAUNCH_SHAPES`` counts the same launches by (kernel, block shape,
dtype), so a run can price them at each shape's time in their own type.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.residual import partial_mode
from repro_torch.kernels import _build
from repro_torch.kernels._build import DBL, INT, PTR
from repro_torch.kernels.jacobi3d.ref import (
    DEFAULT_TILE,
    INF,
    fused_rbgs_sweep_residual_halo_ref,
    fused_rbgs_sweep_residual_ref,
    fused_sweep_residual_halo_ref,
    fused_sweep_residual_ref,
    tile_grid,
)

LAUNCHES: Dict[str, int] = {"fused_sweep_residual": 0,
                            "fused_rbgs_sweep_residual": 0,
                            "fused_sweep_residual_halo": 0,
                            "fused_rbgs_sweep_residual_halo": 0}
LAUNCH_SHAPES: Counter = Counter()   # (kernel, (bx, by, bz), "f64"/"f32") -> launches

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
_PLANES = ("gxm", "gxp", "gym", "gyp", "gzm", "gzp")
# per source: its kernels and their C signature, (the block's inputs: g, or
# x and the six planes; b, out, parts, bx, by, bz, tx, ty, flag, mode,
# 7 coefs, stream)
_SOURCES = {
    "jacobi3d": (("fused_sweep_residual", "fused_rbgs_sweep_residual"),
                 (PTR,) * 4 + (INT,) * 7 + (DBL,) * 7 + (PTR,)),
    "jacobi3d_halo": (("fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo"),
                      (PTR,) * 10 + (INT,) * 7 + (DBL,) * 7 + (PTR,)),
}
_SOURCE_OF = {k: src for src, (kernels, _) in _SOURCES.items() for k in kernels}
_SIGNATURES = {src: {f"{k}_{s}": sig for k in kernels for s in _SUFFIX.values()}
               for src, (kernels, sig) in _SOURCES.items()}

_build.register_counters(LAUNCHES, LAUNCH_SHAPES)


def work(shape: Sequence[int], itemsize: int, op: str = "sweep",
         tile: Tuple[int, int] = DEFAULT_TILE):
    """(operations, bytes) of one ``fused_sweep_residual`` launch on a block
    of ``shape``: 14 operations a cell for r = b − A·x, 2 for its partial
    and 2 more for the sweep's x + r / diag (18 a cell; the residual pass
    16), the ghosted block and b read once, the new block written once
    (not by the residual pass) and 4 bytes a partial."""
    bx, by, bz = shape
    cells = bx * by * bz
    _, _, nx, ny = tile_grid(bx, by, tile)
    sweep = op == "sweep"
    return ((18 if sweep else 16) * cells,
            itemsize * ((bx + 2) * (by + 2) * (bz + 2) + (2 if sweep else 1) * cells)
            + 4 * nx * ny)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def _check_block(b: torch.Tensor) -> None:
    if b.dim() != 3 or min(b.shape) < 1:
        raise ValueError(f"b must be a non-empty 3-D block, got {tuple(b.shape)}")


def _validate(g: torch.Tensor, b: torch.Tensor, pad: Tuple[int, int, int]):
    _check_block(b)
    want = tuple(n + p for n, p in zip(b.shape, pad))
    if tuple(g.shape) != want:
        raise ValueError(f"ghosted block has shape {tuple(g.shape)}, want {want}")
    if g.dtype != b.dtype or b.dtype not in _SUFFIX:
        raise TypeError(f"need matching f32/f64 inputs, got {g.dtype}/{b.dtype}")
    if not (g.is_contiguous() and b.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")


def _planes(halos, b: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The six face planes ``(gxm, gxp, gym, gyp, gzm, gzp)`` checked
    against the block ``[bx, by, bz]`` — x-planes ``[by, bz]``, y-planes
    ``[bx, bz]``, z-planes ``[bx, by]`` — and cast to its dtype, contiguous."""
    _check_block(b)
    if len(halos) != 6:
        raise ValueError(f"need the six face planes {_PLANES}, got {len(halos)}")
    bx, by, bz = b.shape
    want = ((by, bz),) * 2 + ((bx, bz),) * 2 + ((bx, by),) * 2
    for name, h, w in zip(_PLANES, halos, want):
        if tuple(h.shape) != w:
            raise ValueError(f"face plane {name} has shape {tuple(h.shape)}, want {w}")
        if not h.is_floating_point():
            raise TypeError(f"face plane {name} must be floating point, got {h.dtype}")
    return tuple(h.to(b.dtype).contiguous() for h in halos)


def _launch(kernel: str, ins: Sequence[torch.Tensor], b, out: Optional[torch.Tensor],
            tile, flag: int, ord: float, coefs: Sequence[float]) -> torch.Tensor:
    """Launch ``kernel`` on the block's inputs ``ins`` (``g``, or ``x`` and
    the six planes) and the rhs ``b``; returns the partials ``[nx, ny]`` of
    the norm order ``ord``."""
    mode = partial_mode(ord)
    bx, by, bz = b.shape
    tx, ty, nx, ny = tile_grid(bx, by, tile)
    parts = torch.empty((nx, ny), dtype=torch.float32, device=b.device)
    source = _SOURCE_OF[kernel]
    fn = getattr(_build.load(source, _SIGNATURES[source]), f"{kernel}_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(b.device):
        err = fn(*(t.data_ptr() for t in ins), b.data_ptr(),
                 None if out is None else out.data_ptr(), parts.data_ptr(),
                 bx, by, bz, tx, ty, flag, mode, *map(float, coefs),
                 torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, kernel)
    LAUNCHES[kernel] += 1
    LAUNCH_SHAPES[kernel, (bx, by, bz), _SUFFIX[b.dtype]] += 1
    return parts


def fused_sweep_residual(g: torch.Tensor, b: torch.Tensor,
                         coefs: Sequence[float],
                         tile: Tuple[int, int] = DEFAULT_TILE,
                         op: str = "sweep", ord: float = INF):
    """Jacobi sweep of a ±1 ghosted block ``g[(bx+2),(by+2),(bz+2)]`` with
    the input state's residual partials ``[nx, ny]`` (f32).

    ``coefs`` is ``(diag, xm, xp, ym, yp, zm, zp)``.  ``op="residual"`` is
    the residual-only pass: the kernel writes no block, and the returned
    block is a view of ``g``'s interior.  On ``meta`` (a dry rank) nothing
    is computed: the outputs are empty tensors of the plain version's
    shapes and dtypes, and the launch's ``work`` goes to the counting mode.
    """
    if op not in ("sweep", "residual"):
        raise ValueError(f"op {op!r} not in ('sweep', 'residual')")
    if g.device.type == b.device.type == "meta":
        partial_mode(ord)
        _validate(g, b, (2, 2, 2))
        _build.report_work(*work(b.shape, b.element_size(), op, tile))
        _, _, nx, ny = tile_grid(*b.shape[:2], tile)
        parts = torch.empty((nx, ny), dtype=torch.float32, device="meta")
        return (torch.empty_like(b) if op == "sweep" else g[1:-1, 1:-1, 1:-1]), parts
    if not _build.on_cuda(g, b):
        return fused_sweep_residual_ref(g, b, coefs, tile=tile, op=op, ord=ord)
    _validate(g, b, (2, 2, 2))
    out = torch.empty_like(b) if op == "sweep" else None
    parts = _launch("fused_sweep_residual", (g,), b, out, tile, int(op == "sweep"),
                    ord, coefs)
    _build.report_work(*work(b.shape, b.element_size(), op, tile))
    return (g[1:-1, 1:-1, 1:-1] if out is None else out), parts


def fused_rbgs_sweep_residual(g2: torch.Tensor, b: torch.Tensor,
                              coefs: Sequence[float], oxy: int,
                              tile: Tuple[int, int] = DEFAULT_TILE,
                              ord: float = INF):
    """One-pass hybrid red-black GS sweep of a twice-padded block
    ``g2[(bx+4),(by+4),(bz+2)]`` (``ops.ghost_pad2``) with the unpadded rhs
    ``b``, plus the input state's residual partials ``[nx, ny]`` (f32).
    ``oxy = ox + oy`` is the block's global checkerboard phase."""
    if not _build.on_cuda(g2, b):
        return fused_rbgs_sweep_residual_ref(g2, b, coefs, int(oxy), tile=tile,
                                             ord=ord)
    _validate(g2, b, (4, 4, 2))
    out = torch.empty_like(b)
    parts = _launch("fused_rbgs_sweep_residual", (g2,), b, out, tile, int(oxy),
                    ord, coefs)
    return out, parts


def fused_sweep_residual_halo(x: torch.Tensor, halos, b: torch.Tensor,
                              coefs: Sequence[float],
                              tile: Tuple[int, int] = DEFAULT_TILE,
                              op: str = "sweep", ord: float = INF):
    """Jacobi sweep of an unghosted block ``x[bx, by, bz]`` whose ghost
    values are the six face planes ``halos = (gxm, gxp, gym, gyp, gzm,
    gzp)``, with the input state's residual partials ``[nx, ny]`` (f32).

    Planes are cast to the block's dtype.  ``op="residual"`` is the
    residual-only pass: the kernel writes no block and ``x`` is returned.
    """
    if op not in ("sweep", "residual"):
        raise ValueError(f"op {op!r} not in ('sweep', 'residual')")
    halos = _planes(halos, b)
    if not _build.on_cuda(x, b, *halos):
        return fused_sweep_residual_halo_ref(x, halos, b, coefs, tile=tile, op=op,
                                             ord=ord)
    _validate(x, b, (0, 0, 0))
    out = torch.empty_like(b) if op == "sweep" else None
    parts = _launch("fused_sweep_residual_halo", (x, *halos), b, out, tile,
                    int(op == "sweep"), ord, coefs)
    return (x if out is None else out), parts


def fused_rbgs_sweep_residual_halo(x: torch.Tensor, halos, b: torch.Tensor,
                                   coefs: Sequence[float], oxyz: int,
                                   tile: Tuple[int, int] = DEFAULT_TILE,
                                   ord: float = INF):
    """One-pass hybrid red-black GS sweep of an unghosted block and its six
    face planes, plus the input state's residual partials ``[nx, ny]``
    (f32).  ``oxyz = ox + oy + oz`` is the block's global checkerboard
    phase; the ghost values stay frozen during the sweep."""
    halos = _planes(halos, b)
    if not _build.on_cuda(x, b, *halos):
        return fused_rbgs_sweep_residual_halo_ref(x, halos, b, coefs, int(oxyz),
                                                  tile=tile, ord=ord)
    _validate(x, b, (0, 0, 0))
    out = torch.empty_like(b)
    parts = _launch("fused_rbgs_sweep_residual_halo", (x, *halos), b, out, tile,
                    int(oxyz), ord, coefs)
    return out, parts
