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

``make_sharded_solver`` is the distributed solve: x-y blocks (z whole)
over the stacked transport (an ``(nx, ny)`` shape, all blocks on one
device) or one block per rank of a ``launch.mesh.ShardGroup``
(``runtime/transport.py``); the JAX package's ``shard_map`` over a
``(data, model)`` mesh.  ``solve_single`` is the one-device reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import detection
from repro_torch.core import residual as res
from repro_torch.kernels import _build
from repro_torch.kernels.jacobi3d import ops as jac_ops
from repro_torch.launch.mesh import (
    ShardGroup,
    mesh_coords,
    mesh_shape,
    place_blocks,
    shard_axis_names,
)
from repro_torch.runtime.transport import ReductionPipeline, make_transport
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


# ---------------------------------------------------------------------------
# Distributed solve (x-y blocks over a transport)
# ---------------------------------------------------------------------------


def halo_exchange(transport, xs: Dict[int, torch.Tensor], nbrs,
                  zeros: Tuple[torch.Tensor, ...]) -> Dict[int, tuple]:
    """Exchange the four (x, y) faces of each local (bx, by, bz) block.
    ``nbrs[i]`` holds shard i's (x−, x+, y−, y+) neighbour ranks, None at
    the grid's edge.  Returns ``{i: (gxm, gxp, gym, gyp)}``: each ghost the
    facing plane of that neighbour, and at an edge the matching plane of
    ``zeros`` (homogeneous Dirichlet BC)."""
    def faces(x):   # what goes to the (x−, x+, y−, y+) neighbour
        return (x[0], x[-1], x[:, 0].contiguous(), x[:, -1].contiguous())

    sends = {i: {(j, "xxyy"[s]): f for s, (j, f) in enumerate(zip(nbrs[i], faces(x)))
                 if j is not None} for i, x in xs.items()}
    got = transport.route(sends).wait()
    return {i: tuple(z if j is None else got[i][j, "xxyy"[s]]
                     for s, (j, z) in enumerate(zip(nbrs[i], zeros))) for i in xs}


def _axes(ax: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _linear_index(coords: Sequence[int], shape: Sequence[int],
                  names: Tuple[str, ...], axes: Tuple[str, ...]) -> int:
    """Linear rank along possibly-composite mesh axes (row-major over
    ``axes``, in the order given)."""
    idx = 0
    for a in axes:
        d = names.index(a)
        idx = idx * shape[d] + coords[d]
    return idx


def make_sharded_solver(cfg: SolverConfig,
                        mesh: Union[Tuple[int, ...], ShardGroup],
                        ax_x: Optional[Union[str, Tuple[str, ...]]] = None,
                        ax_y: Optional[Union[str, Tuple[str, ...]]] = None,
                        device: DeviceLike = None):
    """Build ``solve(x0, b) -> SolveResult`` over x-y blocks.

    ``mesh`` is a shape ``(nx, ny)`` (1-D to 3-D; the stacked transport on
    ``device``, default ``cuda``) or a ``ShardGroup`` (one block per rank,
    on the group's device).  ``ax_x``/``ax_y`` name the mesh axes
    (``shard_axis_names``; default the first axis and the rest) whose
    product splits the grid's x and y; a composite axis such as
    ``("shard_x", "shard_y")`` is ranked row-major in the order given.  z
    is not partitioned.  ``x0, b`` are global (n, n, n) tensors or numpy
    arrays (over a group, or the rank's block); ``x`` comes back global on
    every rank.

    Per outer iteration, as in JAX: ``inner_sweeps`` sweeps (the last one
    fused with the detection contribution, or a residual-only pass after
    the exchange when ``fuse_residual`` is off), the four-face halo
    exchange, and one check on the reduction launched K checks earlier.
    The red-black parity uses the block's global offsets; NFAIS2's exact
    verification measures the fresh post-exchange state, lazily.
    """
    group = mesh if isinstance(mesh, ShardGroup) else None
    shape = group.shape if group else mesh_shape(mesh)
    names = shard_axis_names(group.axis if group else "shard", len(shape))
    ax_x_t = _axes(names[0] if ax_x is None else ax_x)
    ax_y_t = _axes(names[1:] if ax_y is None else ax_y)
    if sorted(ax_x_t + ax_y_t) != sorted(names):
        raise ValueError(f"ax_x {ax_x_t} and ax_y {ax_y_t} must split the mesh "
                         f"axes {names} between them, each once")
    nx = math.prod(shape[names.index(a)] for a in ax_x_t)
    ny = math.prod(shape[names.index(a)] for a in ax_y_t)
    p = nx * ny
    transport = make_transport(group or p, group.device if group else
                               resolve_device(device))
    dev = transport.device
    # shard rank -> (ix, iy), and back
    ixy = {r: tuple(_linear_index(mesh_coords(r, shape), shape, names, ax)
                    for ax in (ax_x_t, ax_y_t)) for r in range(p)}
    rank_at = {v: r for r, v in ixy.items()}
    nbrs = {r: tuple(rank_at.get((ix + dx, iy + dy)) for dx, dy in
                     ((-1, 0), (1, 0), (0, -1), (0, 1)))
            for r, (ix, iy) in ixy.items()}
    mon_cfg = cfg.monitor

    def solve(x0, b) -> SolveResult:
        b = torch.as_tensor(b)
        n = b.shape[-1]
        if b.dim() != 3 or n % nx or n % ny:
            raise ValueError(f"b must be an (n, n, n) grid with n divisible by the "
                             f"{nx} × {ny} blocks, got {tuple(b.shape)}")
        bx, by = n // nx, n // ny
        sl = {r: (slice(ix * bx, (ix + 1) * bx), slice(iy * by, (iy + 1) * by))
              for r, (ix, iy) in ixy.items()}

        def place(a, dtype=None):
            return place_blocks(a, {i: sl[i] for i in transport.local}, dev, dtype,
                                gshape=(n, n, n), what=f"x0 and b must be ({n}, {n}, {n})")

        bs = place(b)
        dtype = bs[transport.local[0]].dtype
        xs = place(x0, dtype)
        zeros = (torch.zeros((by, n), dtype=dtype, device=dev),) * 2 + \
            (torch.zeros((bx, n), dtype=dtype, device=dev),) * 2
        offs = {i: (ixy[i][0] * bx, ixy[i][1] * by) for i in xs}
        ghosts = halo_exchange(transport, xs, nbrs, zeros)
        reductions = ReductionPipeline(mon_cfg.staleness, mon_cfg.ord, 0, dev)
        mon = detection.init_state(mon_cfg, dev)
        k = 0
        while k < cfg.max_outer:
            contribs = {}
            for i in xs:
                xs[i], contribs[i] = _outer_iteration(cfg, xs[i], ghosts[i], bs[i], *offs[i])
            ghosts = halo_exchange(transport, xs, nbrs, zeros)
            if contribs[next(iter(xs))] is None:
                # unfused baseline: post-exchange residual-only pass
                contribs = {i: _local_contribution(cfg, ghosted(xs[i], ghosts[i]), bs[i])
                            for i in xs}

                def exact_fn(c=contribs):
                    return transport.exact(c, mon_cfg.ord)
            else:
                # the fused contribution is one sweep stale; NFAIS2's exact
                # verification measures the fresh post-exchange state
                def exact_fn(g=ghosts):
                    return transport.exact(
                        {i: _local_contribution(cfg, ghosted(xs[i], g[i]), bs[i])
                         for i in xs}, mon_cfg.ord)
            reductions.launch(transport.reduce(contribs, mon_cfg.ord))
            mon = detection.decide(mon_cfg, mon, reductions.consume(),
                                   exact_residual_fn=exact_fn)
            k += 1
            if bool(mon.converged):  # the loop's one device→host sync
                break
        reductions.drain()
        x = torch.empty((n, n, n), dtype=dtype, device=dev)
        for r, blk in enumerate(transport.all_gather(xs)):
            x[sl[r]] = blk
        return SolveResult(x=x, residual=mon.detected_residual, outer_iters=k,
                           converged=bool(mon.converged))

    return solve
