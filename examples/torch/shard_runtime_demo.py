"""Shard-runtime quickstart on the PyTorch port: the paper's detection
head-to-head on four shards.

Four shards each own an x-pencil of the convection–diffusion state and
free-run with stale halos, lagged reduction lanes and heterogeneous sweep
rates, stacked on one device (the stacked transport; the JAX twin,
``examples/shard_runtime_demo.py``, forces 4 host devices).  The same
monitor (core/detection.py) consumes the global residual produced three
ways:

  blocking     — barrier semantics + an extra exact residual pass (the
                 protocol-style baseline),
  nonblocking  — the paper: fused contribution, K-stale consumption,
  rdoubling    — modified recursive doubling (Zou & Magoulès 2019), one
                 butterfly round per outer step.

Run:  PYTHONPATH=src python examples/torch/shard_runtime_demo.py [--device cpu]
"""
import argparse
import math

import torch

from repro_torch._device import resolve_device
from repro_torch.core import detection
from repro_torch.kernels.jacobi3d import ops as jac_ops
from repro_torch.runtime.shard_runtime import ShardRuntimeConfig, make_convdiff_runtime
from repro_torch.solvers.convdiff import Stencil, make_rhs
from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted

N = 16
P = 4
EPS_TILDE = 1e-6


def exact_residual(st, x, b) -> float:
    """‖b − A x‖₂ through the residual kernel (Σr², then the root)."""
    g = ghosted(x, _zero_ghosts(x))
    return math.sqrt(float(jac_ops.residual_contribution(st, g, b, ord=2.0)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args().device)
    st = Stencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = torch.as_tensor(make_rhs(N, seed=0), device=dev)
    x0 = torch.zeros_like(b)

    print(f"convection–diffusion {N}³ over {P} shards, "
          f"ε̃ = {EPS_TILDE:.0e}\n")
    print(f"{'reduction':12s} {'ε used':>9s} {'outer':>6s} {'sweeps/shard':>14s} "
          f"{'detected r':>11s} {'exact r*':>11s} {'r* < ε̃':>7s}")
    for reduction, mode, margin in (
        ("blocking", "sync", 1.0),       # barrier + exact residual: no margin
        ("nonblocking", "pfait", 10.0),  # the paper: stale + tightened ε
        ("rdoubling", "pfait", 10.0),    # protocol baseline: butterfly rounds
    ):
        mon = detection.for_mode(mode, eps_tilde=EPS_TILDE, margin=margin,
                                 staleness=0 if mode == "sync" else 2)
        asym = {} if reduction == "blocking" else dict(
            inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 2, 1),
            contrib_lag=(0, 1, 0, 1))
        cfg = ShardRuntimeConfig(monitor=mon, reduction=reduction,
                                 max_outer=5000, **asym)
        run = make_convdiff_runtime(cfg, P, st, N, device=dev)
        r = run(x0, b)
        r_star = exact_residual(st, r.x, b)
        sweeps = "/".join(str(int(s)) for s in r.local_sweeps)
        print(f"{reduction:12s} {mon.eps:9.1e} {int(r.outer_iters):6d} "
              f"{sweeps:>14s} {float(r.residual):11.2e} {r_star:11.2e} "
              f"{'yes' if r_star < EPS_TILDE else 'NO':>7s}")

    print("\nnon-blocking detection leaves the reduction off the critical\n"
          "path (zero extra passes); the ε-margin restores the guarantee\n"
          "the barrier used to buy — exactly the paper's trade, on device.")


if __name__ == "__main__":
    main()
