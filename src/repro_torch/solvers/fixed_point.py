"""Fixed-point driver — the single-device solve of the paper's core loop.

Each outer iteration runs ``inner_sweeps`` relaxation sweeps; with
``fuse_residual`` (the default) the last one returns the detection
contribution as a by-product (the residual of the state *before* that
sweep), so an outer iteration is one ghost assembly + one grid pass per
sweep and no residual-only second pass.  The monitor (``core.detection``)
reads a K-stale reduction of those contributions.  ``fuse_residual=False``
restores the unfused two-pass baseline.

On the card every sweep and residual pass goes through the jacobi3d kernel
ops, whatever ``use_kernel`` says: a CUDA tensor launches a kernel or
raises (for an ``ord`` the kernels lack).  On the CPU ``use_kernel`` picks
the ops' plain versions or the solvers' own sweeps, as the JAX flag does.

The JAX package's ``lax.while_loop`` is a Python loop here whose predicate
reads ``converged`` on the host: one device→host sync per outer iteration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core import residual as res
from repro_torch.kernels import _build
from repro_torch.kernels.jacobi3d import ops as jac_ops
from repro_torch.solvers import gauss_seidel, jacobi
from repro_torch.solvers.convdiff import Stencil

#: the (bx+2, by+2, bz+2) ghosted block (z ghosts = BC = 0)
ghosted = jac_ops.ghost_pad1


class SolveResult(NamedTuple):
    x: torch.Tensor                  # solution
    residual: torch.Tensor           # f32 residual that fired detection (stale)
    outer_iters: int                 # outer iterations executed
    converged: bool


@dataclass(frozen=True)
class SolverConfig:
    stencil: Stencil
    monitor: detection.MonitorConfig
    inner_sweeps: int = 1        # bounded-delay asynchrony (s)
    max_outer: int = 10_000
    sweep: str = "hybrid"        # "hybrid" (RB-GS interior) | "jacobi"
    use_kernel: bool = False     # CPU: sweeps through the kernel ops (card: always)
    fuse_residual: bool = True   # residual as sweep by-product (no 2nd pass)


def ghosted6(x: torch.Tensor, ghosts) -> torch.Tensor:
    """The (bx+2, by+2, bz+2) ghosted block from six face planes
    ``(gxm, gxp, gym, gyp, gzm, gzp)`` — the mesh runtime's assembly, where
    any of x/y/z may be partitioned.  Unpartitioned or boundary faces pass
    the zero Dirichlet plane; corners and edges stay zero (the 7-point
    stencil never reads them)."""
    gxm, gxp, gym, gyp, gzm, gzp = ghosts
    bx, by, bz = x.shape
    g = x.new_zeros((bx + 2, by + 2, bz + 2))
    g[1:-1, 1:-1, 1:-1] = x
    g[0, 1:-1, 1:-1] = gxm
    g[-1, 1:-1, 1:-1] = gxp
    g[1:-1, 0, 1:-1] = gym
    g[1:-1, -1, 1:-1] = gyp
    g[1:-1, 1:-1, 0] = gzm
    g[1:-1, 1:-1, -1] = gzp
    return g


def _zero_ghosts(x: torch.Tensor):
    bx, by, bz = x.shape
    return (x.new_zeros((by, bz)), x.new_zeros((by, bz)),
            x.new_zeros((bx, bz)), x.new_zeros((bx, bz)))


def _use_ops(cfg: SolverConfig, x: torch.Tensor) -> bool:
    """The kernel ops serve every CUDA tensor; the plain sweeps CPU ones only."""
    return cfg.use_kernel or _build.on_cuda(x)


def _sweep_block(cfg: SolverConfig, x, ghosts, b, ox: int, oy: int) -> torch.Tensor:
    """One sweep, contribution discarded."""
    if _use_ops(cfg, x):
        return jac_ops.sweep(cfg.stencil, x, ghosts, b, sweep=cfg.sweep,
                             ox=ox, oy=oy)
    g = ghosted(x, ghosts)
    if cfg.sweep == "jacobi":
        return jacobi.jacobi_sweep(cfg.stencil, g, b)
    return gauss_seidel.redblack_gs_sweep(cfg.stencil, g, b, ox, oy)


def _sweep_with_contribution(cfg: SolverConfig, x, ghosts, b, ox: int, oy: int):
    """The fused hot path: ``(new_x, contrib)`` from one ghost assembly and
    one grid pass; ``contrib`` is the pre-σ residual contribution of the
    *input* state."""
    if _use_ops(cfg, x):
        return jac_ops.sweep_with_contribution(
            cfg.stencil, x, ghosts, b, sweep=cfg.sweep, ox=ox, oy=oy,
            ord=cfg.monitor.ord)
    g = ghosted(x, ghosts)
    if cfg.sweep == "jacobi":
        new, r = jacobi.jacobi_sweep_residual(cfg.stencil, g, b)
    else:
        new, r = gauss_seidel.redblack_gs_sweep_residual(cfg.stencil, g, b, ox, oy)
    return new, res.local_contribution(r, cfg.monitor.ord)


def _local_contribution(cfg: SolverConfig, g, b) -> torch.Tensor:
    """Residual-only pass (unfused baseline + NFAIS2 exact verification)."""
    if _use_ops(cfg, g):
        return jac_ops.residual_contribution(cfg.stencil, g, b, ord=cfg.monitor.ord)
    return res.local_contribution(jacobi.residual_block(cfg.stencil, g, b),
                                  cfg.monitor.ord)


def _outer_iteration(cfg: SolverConfig, x, ghosts, b, ox: int, oy: int):
    """``inner_sweeps`` sweeps, the last one fused with the detection
    contribution; the contribution is None when ``fuse_residual`` is off."""
    if cfg.fuse_residual:
        for _ in range(cfg.inner_sweeps - 1):
            x = _sweep_block(cfg, x, ghosts, b, ox, oy)
        return _sweep_with_contribution(cfg, x, ghosts, b, ox, oy)
    for _ in range(cfg.inner_sweeps):
        x = _sweep_block(cfg, x, ghosts, b, ox, oy)
    return x, None


def solve_single(cfg: SolverConfig, b, x0=None,
                 device: DeviceLike = None) -> SolveResult:
    """p = 1 solve (ghosts are the physical boundary, zeros).

    ``b`` and ``x0`` are tensors or numpy arrays; they are moved to
    ``device`` (default ``cuda``) keeping their floating type."""
    dev = resolve_device(device)
    b = torch.as_tensor(b, device=dev)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(
        x0, device=dev, dtype=b.dtype)
    mon_cfg = cfg.monitor
    zg = _zero_ghosts(x)
    mon = detection.init_state(mon_cfg, dev)
    k = 0
    while k < cfg.max_outer:
        x, contrib = _outer_iteration(cfg, x, zg, b, 0, 0)
        if contrib is None:  # unfused baseline: residual-only second pass
            contrib = _local_contribution(cfg, ghosted(x, zg), b)

            def exact_fn(c=contrib):
                return res.sigma(c, mon_cfg.ord)
        else:
            def exact_fn(x=x):
                return res.sigma(_local_contribution(cfg, ghosted(x, zg), b),
                                 mon_cfg.ord)
        mon = detection.step(mon_cfg, mon, contrib, exact_residual_fn=exact_fn)
        k += 1
        if bool(mon.converged):  # the loop's one device→host sync
            break
    return SolveResult(x=x, residual=mon.detected_residual, outer_iters=k,
                       converged=bool(mon.converged))
