"""Convection–diffusion on the x-pencil shard runtime: the shards stacked
on one card, or one a rank of a world (a ``ShardGroup``).

Set-up places nothing large: a solve's right-hand side is drawn on the
device from the solve's seed (``rhs``), and its start is zero; every rank
draws the same global ones, and the runtime places the rank's block.  The
program's entry is ``repro_torch.runtime.shard_runtime.make_runtime``; the
plain reference is ``reference/convdiff.py``."""
from __future__ import annotations

import math

import torch

from perfbench import traffic as tr
from perfbench.reference import convdiff as ref

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def tiny(config: dict) -> dict:
    """What makes ``config`` a twin that the CPU's plain paths run in a
    second: n = 16 on 4 stacked shards, or a world's shards, one a rank,
    over gloo."""
    if "backend" in config:
        return {"n": 16, "backend": "gloo"}
    return {"n": 16, "shards": 4}


def rhs(n: int, seed: int, dtype: torch.dtype, device, noise: float) -> torch.Tensor:
    """b = sin πx sin πy sin πz + 0.3 sin 2πx cos πz + noise·N(0, 1) on
    the n³ interior nodes of [0, 1]³, drawn on ``device`` from ``seed``
    (the smooth formula of the paper's experiment), in slabs of planes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randn((n, n, n), generator=gen, device=device, dtype=dtype)
    b.mul_(noise)
    xs = torch.linspace(0, 1, n + 2, dtype=torch.float64, device=device)[1:-1]
    s, s2, cz = (f(c * xs).to(dtype) for f, c in
                 ((torch.sin, math.pi), (torch.sin, 2 * math.pi), (torch.cos, math.pi)))
    slab = max(1, (1 << 24) // (n * n))
    for lo in range(0, n, slab):
        sl = slice(lo, lo + slab)
        b[sl] += s[sl, None, None] * s[None, :, None] * s[None, None, :]
        b[sl] += 0.3 * s2[sl, None, None] * cz[None, None, :]
    return b


class Problem:
    """One configuration's solves under one mix, on ``device``: over the
    stacked transport, or over ``group``, this rank's ``ShardGroup``."""

    def __init__(self, config: dict, mix: tr.Mix, seed: int, device, group=None):
        if config["norm"] != 2:
            raise ValueError("the convdiff reference runs the l2 norm")
        self.n, self.p = int(config["n"]), int(config["shards"])
        self.dtype = DTYPES[config["dtype"]]
        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self.group = group
        self.eps_tilde = float(config["eps_tilde"])
        self.coefs = ref.coefficients(self.n, config["nu"], config["a"], config["rho"])

    def rhs(self, index: int) -> torch.Tensor:
        return rhs(self.n, tr.solve_seed(self.seed, index), self.dtype, self.device,
                   self.config["rhs_noise"])

    def inputs(self, index: int):
        """Solve ``index``'s (x0, b): x0 = 0."""
        return torch.zeros((self.n,) * 3, dtype=self.dtype, device=self.device), self.rhs(index)

    def runtime(self, max_outer: int):
        """The program's ``run(x0, b)``, built as ``runtime.api.run_shard``
        builds it, recording the monitor's series."""
        from repro_torch.core import detection
        from repro_torch.runtime.api import RuntimeConfig
        from repro_torch.runtime.shard_runtime import make_runtime
        from repro_torch.solvers.convdiff import Stencil

        c, m = self.config, self.mix
        mon = detection.for_mode(m.mode, eps_tilde=self.eps_tilde, margin=m.margin,
                                 staleness=m.staleness, ord=float(c["norm"]))
        rc = RuntimeConfig(monitor=mon, reduction=m.reduction, inner_sweeps=m.inner_sweeps,
                           halo_delay=m.halo_delay, contrib_lag=m.contrib_lag,
                           max_outer=max_outer, trace_len=max_outer)
        st = Stencil.for_contraction(self.n, c["nu"], tuple(c["a"]), c["rho"])
        return make_runtime("convdiff", rc.to_shard_config(), self.group or self.p, self.n,
                            stencil=st, device=self.device)

    def reference(self, index: int, max_outer: int) -> ref.Solve:
        """The plain reference's solve ``index``."""
        m = self.mix
        return ref.solve(self.rhs(index), None, self.coefs, self.p,
                         reduction=m.reduction,
                         staleness=m.staleness_seen, eps=m.eps(self.eps_tilde),
                         inner=m.inner_sweeps, halo_delay=m.halo_delay,
                         contrib_lag=m.contrib_lag, max_outer=max_outer)

    def exact_residual(self, index: int, x: torch.Tensor) -> float:
        return ref.exact_residual(x, self.rhs(index), self.coefs)

    @staticmethod
    def gap(x: torch.Tensor, want: torch.Tensor) -> float:
        """‖x − want‖₂ / ‖want‖₂ in f64, a few pencils at a time; ``want``
        is the reference's [p, n / p, n, n] view."""
        x = x.reshape(want.shape)
        d = w = 0.0
        for i in range(0, x.shape[0], 16):
            a, b = x[i:i + 16].to(torch.float64), want[i:i + 16].to(torch.float64)
            d += float(torch.linalg.vector_norm(a - b).square())
            w += float(torch.linalg.vector_norm(b).square())
        return (d / w) ** 0.5
