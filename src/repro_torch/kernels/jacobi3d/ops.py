"""Dispatch layer of the jacobi3d kernels — the solvers' entry points on the
card, and on the CPU when ``SolverConfig.use_kernel`` is set.

Each entry does its own ghost assembly from ``(x, ghosts)`` — the Jacobi
kernel wants the ±1 ghosted layout, the hybrid RB-GS kernel the ±2 one —
so a caller pays exactly one assembly per sweep.  ``sweep_with_contribution``
is the fused hot path: one assembly + one kernel launch yields both the
swept block and the detection layer's local contribution (the residual of
the *input* state).  The kernel wrappers pick the device: CPU tensors run
the plain versions, CUDA tensors the kernels.

The ``*_halo`` entries are the shard runtimes' (every sweep and residual
pass of the 1-D and the mesh runtime): an unghosted block and six face
planes go to the halo-consuming kernels as they are, with no ghost
assembly at all.

``PASS_COUNTS`` counts calls per entry kind so tests can check that the
solver drivers make the expected number of grid passes (in particular: no
residual-only second pass on the fused path).  The JAX package counts at
trace time; PyTorch runs eagerly, so here every call counts.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.kernels.jacobi3d.jacobi3d import (
    fused_rbgs_sweep_residual,
    fused_rbgs_sweep_residual_halo,
    fused_sweep_residual,
    fused_sweep_residual_halo,
)
from repro_torch.kernels.jacobi3d.ref import DEFAULT_TILE
from repro_torch.solvers.convdiff import Stencil

PASS_COUNTS: Dict[str, int] = {"sweep": 0, "fused": 0, "residual": 0}


def reset_pass_counts() -> None:
    for k in PASS_COUNTS:
        PASS_COUNTS[k] = 0


def _reduce(parts: torch.Tensor, ord: float) -> torch.Tensor:
    """A block's pre-σ contribution from its partials: their max for l∞,
    their sum for l2 (Σr²) and l1 (Σ|r|).  (The kernel wrappers raise for
    any other order.)"""
    return parts.amax() if np.isinf(ord) else parts.sum()


# ---------------------------------------------------------------------------
# Ghost assembly (z ghosts = Dirichlet BC = 0)
# ---------------------------------------------------------------------------


def _assemble(x: torch.Tensor, ghosts, pad: int, buf) -> torch.Tensor:
    """Interior + the 4 (x,y) face planes ``(gxm, gxp, gym, gyp)`` into a
    block padded by ``pad`` in x and y (ghosts one ring in) and 1 in z.
    ``buf`` — a persistent buffer of that shape to assemble into (its
    outer rings and z ghosts stay as they are: zero), else a fresh zero
    block.  A face given as None is not written, so it reads zero in a
    fresh block and whatever the buffer last held in a persistent one."""
    bx, by, bz = x.shape
    shape = (bx + 2 * pad, by + 2 * pad, bz + 2)
    if buf is None:
        g = x.new_zeros(shape)
    elif tuple(buf.shape) != shape:
        raise ValueError(f"ghost buffer has shape {tuple(buf.shape)}, want {shape}")
    else:
        g = buf
    lo, hi, z = pad - 1, bx + pad, slice(1, -1)
    ylo, yhi = pad - 1, by + pad
    xs, ys = slice(pad, bx + pad), slice(pad, by + pad)
    g[xs, ys, z] = x
    for face, idx in zip(ghosts, ((lo, ys, z), (hi, ys, z), (xs, ylo, z), (xs, yhi, z))):
        if face is not None:
            g[idx] = face
    if spans.counting():
        # a fresh block's zero fill, then the interior and each face written
        spans.count("ghost_bytes", g.element_size() * (
            (g.numel() if buf is None else 0) + x.numel()
            + sum(face.numel() for face in ghosts if face is not None)))
    return g


def ghost_pad1(x: torch.Tensor, ghosts, buf=None) -> torch.Tensor:
    """(bx+2, by+2, bz+2) ghosted block from interior + 4 (x,y) face planes
    ``(gxm, gxp, gym, gyp)``, in ``buf`` where given (see ``_assemble``)."""
    return _assemble(x, ghosts, 1, buf)


def ghost_pad2(x: torch.Tensor, ghosts, buf=None) -> torch.Tensor:
    """(bx+4, by+4, bz+2) twice-padded block for the RB-GS kernel: ghosts sit
    one ring in; the outermost ring is never read.  In ``buf`` where given
    (see ``_assemble``)."""
    return _assemble(x, ghosts, 2, buf)


# ---------------------------------------------------------------------------
# Fused sweep + residual partials (single implementation, two public faces)
# ---------------------------------------------------------------------------


def _sweep_impl(st: Stencil, x, ghosts, b, sweep, ox, oy, tile, ord, buf):
    """One relaxation sweep fused with the input-state residual partials."""
    if sweep == "jacobi":
        return fused_sweep_residual(ghost_pad1(x, ghosts, buf), b, st.coefs,
                                    tile=tile, op="sweep", ord=ord)
    if sweep != "hybrid":
        raise ValueError(f"sweep {sweep!r} not in ('jacobi', 'hybrid')")
    return fused_rbgs_sweep_residual(ghost_pad2(x, ghosts, buf), b, st.coefs,
                                     int(ox) + int(oy), tile=tile, ord=ord)


def sweep(st: Stencil, x: torch.Tensor, ghosts, b: torch.Tensor,
          sweep: str = "jacobi", ox: int = 0, oy: int = 0,
          tile: Tuple[int, int] = DEFAULT_TILE, buf=None) -> torch.Tensor:
    """Sweep-only entry (inner sweeps that don't feed detection; the
    kernel's partials are discarded).  ``buf``: a persistent buffer to
    assemble the ghosted block in (``ghost_pad1`` / ``ghost_pad2``)."""
    PASS_COUNTS["sweep"] += 1
    new, _ = _sweep_impl(st, x, ghosts, b, sweep, ox, oy, tile, float("inf"), buf)
    return new


def sweep_with_contribution(st: Stencil, x: torch.Tensor, ghosts,
                            b: torch.Tensor, sweep: str = "jacobi",
                            ox: int = 0, oy: int = 0,
                            ord: float = float("inf"),
                            tile: Tuple[int, int] = DEFAULT_TILE, buf=None):
    """Fused hot path: ``(new_block, contrib)`` in one assembly + one pass.

    ``contrib`` is the pre-σ local contribution (max|r| for l∞, Σr² for
    l2, Σ|r| for l1) of the *input* state's residual — one sweep staler
    than a dedicated post-sweep pass, which the detection layer tolerates
    by design.  ``buf`` as in ``sweep``."""
    PASS_COUNTS["fused"] += 1
    new, parts = _sweep_impl(st, x, ghosts, b, sweep, ox, oy, tile, ord, buf)
    return new, _reduce(parts, ord)


def residual_contribution(st: Stencil, g: torch.Tensor, b: torch.Tensor,
                          ord: float = float("inf"),
                          tile: Tuple[int, int] = DEFAULT_TILE) -> torch.Tensor:
    """Residual-only pass over a ±1 ghosted block (unfused baseline path,
    NFAIS2's exact verification and blocking mode's barrier pass)."""
    PASS_COUNTS["residual"] += 1
    _, parts = fused_sweep_residual(g, b, st.coefs, tile=tile, op="residual",
                                    ord=ord)
    return _reduce(parts, ord)


# ---------------------------------------------------------------------------
# Halo-consuming entries (unghosted block + six face planes)
# ---------------------------------------------------------------------------


def _sweep_halo_impl(st: Stencil, x, halos, b, sweep, ox, oy, oz, tile, ord):
    """Twin of ``_sweep_impl`` for the shard runtimes, where any of x/y/z
    may be partitioned: ``halos = (gxm, gxp, gym, gyp, gzm, gzp)``."""
    if sweep == "jacobi":
        return fused_sweep_residual_halo(x, halos, b, st.coefs, tile=tile,
                                         op="sweep", ord=ord)
    if sweep != "hybrid":
        raise ValueError(f"sweep {sweep!r} not in ('jacobi', 'hybrid')")
    return fused_rbgs_sweep_residual_halo(x, halos, b, st.coefs,
                                          int(ox) + int(oy) + int(oz),
                                          tile=tile, ord=ord)


def sweep_halo(st: Stencil, x: torch.Tensor, halos, b: torch.Tensor,
               sweep: str = "jacobi", ox: int = 0, oy: int = 0, oz: int = 0,
               tile: Tuple[int, int] = DEFAULT_TILE) -> torch.Tensor:
    """Halo-plane sweep-only entry (the kernel's partials are discarded)."""
    PASS_COUNTS["sweep"] += 1
    new, _ = _sweep_halo_impl(st, x, halos, b, sweep, ox, oy, oz, tile, float("inf"))
    return new


def sweep_with_contribution_halo(st: Stencil, x: torch.Tensor, halos,
                                 b: torch.Tensor, sweep: str = "jacobi",
                                 ox: int = 0, oy: int = 0, oz: int = 0,
                                 ord: float = float("inf"),
                                 tile: Tuple[int, int] = DEFAULT_TILE):
    """Fused halo-plane hot path: ``(new_block, contrib)`` in one pass;
    ``contrib`` is the pre-σ contribution of the *input* state's residual:
    Σ|r| at l1 (where the JAX halo ops return Σr²)."""
    PASS_COUNTS["fused"] += 1
    new, parts = _sweep_halo_impl(st, x, halos, b, sweep, ox, oy, oz, tile, ord)
    return new, _reduce(parts, ord)


def residual_contribution_halo(st: Stencil, x: torch.Tensor, halos,
                               b: torch.Tensor, ord: float = float("inf"),
                               tile: Tuple[int, int] = DEFAULT_TILE) -> torch.Tensor:
    """Residual-only pass from an unghosted block and six face planes
    (blocking mode's barrier pass and NFAIS2's exact verification)."""
    PASS_COUNTS["residual"] += 1
    _, parts = fused_sweep_residual_halo(x, halos, b, st.coefs, tile=tile,
                                         op="residual", ord=ord)
    return _reduce(parts, ord)
