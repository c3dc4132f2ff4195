"""3-D convection–diffusion problem (paper §4.1).

    ∂u/∂t − ν Δu + a·∇u = s   on [0,1]³, homogeneous Dirichlet BC.

Backward-Euler + centred finite differences give, per time step, a sparse
linear system ``A x = b`` with the 7-point stencil

    diag       : 1/dt + 6ν/h²
    x∓ /y∓ /z∓ : −ν/h² ∓ a_d/(2h)      (d = x, y, z)

solved by relaxation.  The Jacobi iteration matrix has spectral radius
ρ ≈ (6ν/h²)/(1/dt + 6ν/h²) < 1, so ``dt`` controls the contraction rate;
``for_contraction`` picks dt for a target ρ.

``ConvDiffProblem`` is the JAX package's problem class: its geometry and
seeded rhs, the batched step of the detection lanes
(``update_with_residual_batched``, ``lane_x0``, ``lane_operands``), and the
event-level methods the asynchronous engine (``core/async_engine.py``)
calls, whose blocks live on ``device`` and whose every sweep and residual
pass is a launch of the jacobi3d kernels there (#2 for the hybrid sweep,
#1 for Jacobi and for residual-only passes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.residual import combine_contributions
from repro_torch.solvers.partition import GridPartition, process_grid

#: the ghost planes' order in the kernel ops, ``(gxm, gxp, gym, gyp)``
_SIDES = ("x-", "x+", "y-", "y+")


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


class _EventState:
    """The event-level methods' per-worker device state.

    ``faces[i]`` is worker i's persistent face set: the last face received
    from each neighbour, by ``_SIDES`` position (None on a domain
    boundary, where the ghost stays zero).  The fused path assembles its
    ghosted blocks from it in persistent buffers, so a neighbour whose
    dependency is missing keeps its last face there, as the JAX package's
    never re-zeroed ghost buffer does; the unfused path zero-fills a fresh
    block instead.  ``gbuf[i]`` is the sweep's layout (±2 in x/y for the
    hybrid kernel, ±1 for Jacobi), ``rbuf[i]`` the ±1 layout of the
    residual-only pass (the same buffer for Jacobi).
    """

    def __init__(self, prob: "ConvDiffProblem", device: torch.device):
        part = prob.part
        bx, by, bz = part.block
        self.device = device
        self.b_global = torch.as_tensor(prob.b_global, dtype=torch.float64,
                                        device=device).contiguous()
        self.offsets = [part.offsets(i) for i in range(prob.p)]
        self.b = [self.b_global[ox:ox + bx, oy:oy + by].contiguous()
                  for ox, oy in self.offsets]
        self.neighbors = [part.neighbors(i) for i in range(prob.p)]
        self.side = [{j: _SIDES.index(part.side(i, j)) for j in nb}
                     for i, nb in enumerate(self.neighbors)]
        self.faces: List[List[Optional[torch.Tensor]]] = [[None] * 4 for _ in range(prob.p)]

        def zeros(pad):
            return torch.zeros((bx + 2 * pad, by + 2 * pad, bz + 2),
                               dtype=torch.float64, device=device)

        self.rbuf = [zeros(1) for _ in range(prob.p)]
        self.gbuf = (self.rbuf if prob.sweep == "jacobi"
                     else [zeros(2) for _ in range(prob.p)])
        self.gexact: Optional[torch.Tensor] = None   # the (n+2)³ ghosted grid

    def fill(self, i: int, deps: Dict[int, torch.Tensor]) -> Tuple:
        """Worker i's face set after taking every dependency present."""
        faces = self.faces[i]
        for j, s in self.side[i].items():
            dep = deps.get(j)
            if dep is not None:
                faces[s] = dep
        return tuple(faces)

    def fresh(self, i: int, deps: Dict[int, torch.Tensor]) -> Tuple:
        """The faces of ``deps`` alone (None where missing: zero-filled)."""
        faces: List[Optional[torch.Tensor]] = [None] * 4
        for j, s in self.side[i].items():
            faces[s] = deps.get(j)
        return tuple(faces)


class ConvDiffProblem:
    """The paper's experiment: an ``n³`` grid over a ``p``-worker process
    grid (validated as the JAX package's), the stencil for a contraction
    ``rho`` and the rhs of ``seed``.

    The event-level methods keep their blocks on ``device`` (the card
    unless the caller asks for another; resolved at their first call, so
    a lane-only caller never needs one) in f64, and count in ``syncs``
    every device→host read of a residual they make.  At ord 1 a
    contribution is Σ|r| and ``exact_residual`` the exact Σ|b − Ax| (the
    kernels' l1 mode); only ord 1, 2 and ∞ exist.
    """

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
        device: DeviceLike = None,
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
        self._device = device
        self._ev: Optional[_EventState] = None
        self.syncs = 0   # device→host residual reads of the event methods

    # -- event-level methods (core/async_engine.py:DecomposedProblem) ---------
    def _events(self) -> _EventState:
        if self._ev is None:
            self._ev = _EventState(self, resolve_device(self._device))
        return self._ev

    def _read(self, contrib: torch.Tensor) -> float:
        self.syncs += 1
        return float(contrib)

    def neighbors(self, i: int) -> List[int]:
        return self._events().neighbors[i]

    def init_local(self, i: int) -> torch.Tensor:
        return torch.zeros(self.part.block, dtype=torch.float64,
                           device=self._events().device)

    def interface(self, i: int, x_i: torch.Tensor, j: int) -> torch.Tensor:
        """Face of i facing j, as a fresh contiguous tensor (the reference
        escapes into deps, in-flight messages and snapshot records)."""
        s = self._events().side[i][j]
        face = (x_i[0], x_i[-1], x_i[:, 0], x_i[:, -1])[s]
        return face.clone(memory_format=torch.contiguous_format)

    def update(self, i: int, x_i: torch.Tensor,
               deps: Dict[int, torch.Tensor]) -> torch.Tensor:
        """One sweep against a fresh zero-filled view (missing deps read 0)."""
        from repro_torch.kernels.jacobi3d import ops

        ev = self._events()
        ox, oy = ev.offsets[i]
        return ops.sweep(self.st, x_i, ev.fresh(i, deps), ev.b[i], self.sweep, ox, oy)

    def update_with_residual(self, i: int, x_i: torch.Tensor,
                             deps: Dict[int, torch.Tensor],
                             need_residual: bool = True):
        """Fused sweep + the *input* state's residual contribution, one
        launch of #2 (hybrid, phase ``ox + oy``) or #1 (Jacobi) on the
        worker's persistent buffer.  ``r_i`` is None, and nothing is read
        back, when ``need_residual`` is False."""
        from repro_torch.kernels.jacobi3d import ops

        ev = self._events()
        ox, oy = ev.offsets[i]
        faces = ev.fill(i, deps)
        if not need_residual:
            return ops.sweep(self.st, x_i, faces, ev.b[i], self.sweep, ox, oy,
                             buf=ev.gbuf[i]), None
        new, contrib = ops.sweep_with_contribution(
            self.st, x_i, faces, ev.b[i], self.sweep, ox, oy, ord=self.ord,
            buf=ev.gbuf[i])
        return new, self._read(contrib)

    def local_residual(self, i: int, x_i: torch.Tensor,
                       deps: Dict[int, torch.Tensor]) -> float:
        """Residual contribution against a fresh zero-filled view (#1,
        residual-only)."""
        from repro_torch.kernels.jacobi3d import ops

        ev = self._events()
        g = ops.ghost_pad1(x_i, ev.fresh(i, deps))
        return self._read(ops.residual_contribution(self.st, g, ev.b[i], ord=self.ord))

    def local_residual_fast(self, i: int, x_i: torch.Tensor,
                            deps: Dict[int, torch.Tensor]) -> float:
        """``local_residual`` through the persistent face set and buffer
        (the fused path's: PFAIT samples it at every reduction slot)."""
        from repro_torch.kernels.jacobi3d import ops

        ev = self._events()
        g = ops.ghost_pad1(x_i, ev.fill(i, deps), buf=ev.rbuf[i])
        return self._read(ops.residual_contribution(self.st, g, ev.b[i], ord=self.ord))

    def exact_residual(self, xs: Sequence[torch.Tensor]) -> float:
        """r(x̄): #1's residual-only pass over the global ±1 ghosted grid
        (Dirichlet zeros; the interior overwritten each call), in the
        problem's norm (l1: Σ|r|, l2: √Σr², l∞: max|r|)."""
        from repro_torch.kernels.jacobi3d import ops

        ev = self._events()
        if ev.gexact is None:
            ev.gexact = torch.zeros((self.n + 2,) * 3, dtype=torch.float64,
                                    device=ev.device)
        self._place(ev.gexact[1:-1, 1:-1, 1:-1], xs)
        contrib = ops.residual_contribution(self.st, ev.gexact, ev.b_global, ord=self.ord)
        return combine_contributions([self._read(contrib)], self.ord)

    def _place(self, u: torch.Tensor, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        bx, by, _ = self.part.block
        for i, (ox, oy) in enumerate(self._events().offsets):
            u[ox:ox + bx, oy:oy + by, :] = xs[i]
        return u

    def assemble(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global ``n³`` state from the workers' blocks."""
        return self._place(torch.zeros((self.n,) * 3, dtype=torch.float64,
                                       device=self._events().device), xs)

    def solve_reference(self, tol: float = 1e-12, max_iter: int = 100_000) -> torch.Tensor:
        """Sequential Jacobi to high precision (test oracle; plain PyTorch
        on the problem's device, one host read an iteration)."""
        from repro_torch.solvers.jacobi import jacobi_sweep

        ev = self._events()
        g = torch.zeros((self.n + 2,) * 3, dtype=torch.float64, device=ev.device)
        inner = g[1:-1, 1:-1, 1:-1]
        for _ in range(max_iter):
            new = jacobi_sweep(self.st, g, ev.b_global)
            delta = float((new - inner).abs().max())
            inner.copy_(new)
            if delta < tol:
                break
        return inner.clone()

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
