"""The port's ``solve_single`` against the JAX package's.

Same stencil, rhs (numpy, seeded) and configs — every port config is built
from the JAX one with ``repro_torch.interop``.  ``outer_iters`` and
``converged`` must be equal, the detected residual within rel 1e-5 (f32
reductions in another order) and ``x`` within atol 1e-10 (f64).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import detection as jdet
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.convdiff import make_rhs
from repro.solvers.fixed_point import SolverConfig as JSolverConfig
from repro.solvers.fixed_point import solve_single as jsolve_single
from repro_torch import interop
from repro_torch.kernels.jacobi3d import ops as tops
from repro_torch.solvers import fixed_point as tfp

INF = float("inf")
N = 8


def _cfgs(mode, sweep, fuse, ord=INF, inner=2, use_kernel=True):
    st = JStencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    mon = jdet.for_mode(mode, eps_tilde=1e-6, margin=10.0,
                        staleness=0 if mode == "sync" else 3, persistence=3, ord=ord)
    jcfg = JSolverConfig(stencil=st, monitor=mon, inner_sweeps=inner, max_outer=2000,
                         sweep=sweep, use_kernel=use_kernel, fuse_residual=fuse)
    return jcfg, interop.solver_config_from(jcfg)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("sweep", ["hybrid", "jacobi"])
@pytest.mark.parametrize("mode", ["sync", "pfait", "nfais2", "nfais5"])
def test_solve_single_matches_jax(mode, sweep, fuse):
    jcfg, tcfg = _cfgs(mode, sweep, fuse)
    b = make_rhs(N, seed=0)
    want = jsolve_single(jcfg, jnp.asarray(b))
    got = tfp.solve_single(tcfg, b, device="cpu")
    assert got.converged == bool(want.converged) is True
    assert got.outer_iters == int(want.outer_iters)
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_solve_single_l2_and_plain_path_match_jax(use_kernel):
    jcfg, tcfg = _cfgs("pfait", "hybrid", True, ord=2.0, inner=1, use_kernel=use_kernel)
    b = make_rhs(N, seed=1)
    x0 = np.random.default_rng(2).standard_normal((N, N, N)) * 0.1
    want = jsolve_single(jcfg, jnp.asarray(b), jnp.asarray(x0))
    got = tfp.solve_single(tcfg, interop.tensor_from(b, "cpu"), x0=x0, device="cpu")
    assert got.outer_iters == int(want.outer_iters) and got.converged
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)


@pytest.mark.parametrize("sweep,fuse", [("hybrid", True), ("jacobi", True), ("hybrid", False)])
@pytest.mark.parametrize("mode", ["sync", "pfait", "nfais2", "nfais5"])
def test_solve_single_l1_matches_jax_plain(mode, sweep, fuse):
    """ord 1: the port's kernel path (per-tile Σ|r| partials) against JAX
    ``solve_single`` on its plain path (``local_contribution(r, 1)``); the
    JAX kernel ops are no reference here, as they pick Σr² for every finite
    order."""
    jcfg, _ = _cfgs(mode, sweep, fuse, ord=1.0, use_kernel=False)
    _, tcfg = _cfgs(mode, sweep, fuse, ord=1.0, use_kernel=True)
    b = make_rhs(N, seed=0)
    want = jsolve_single(jcfg, jnp.asarray(b))
    got = tfp.solve_single(tcfg, b, device="cpu")
    assert got.converged == bool(want.converged) is True
    assert got.outer_iters == int(want.outer_iters)
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)


@pytest.mark.parametrize("inner", [1, 3])
def test_fused_path_pass_counts(inner):
    """pfait, fused: per outer iteration one fused call, inner−1 plain
    sweeps and no residual-only pass (the port counts per call)."""
    _, tcfg = _cfgs("pfait", "hybrid", True, inner=inner)
    tops.reset_pass_counts()
    r = tfp.solve_single(tcfg, make_rhs(N, seed=0), device="cpu")
    assert tops.PASS_COUNTS == {"sweep": (inner - 1) * r.outer_iters,
                                "fused": r.outer_iters, "residual": 0}


def test_unfused_path_pass_counts():
    _, tcfg = _cfgs("pfait", "jacobi", False, inner=2)
    tops.reset_pass_counts()
    r = tfp.solve_single(tcfg, make_rhs(N, seed=0), device="cpu")
    assert tops.PASS_COUNTS == {"sweep": 2 * r.outer_iters, "fused": 0,
                                "residual": r.outer_iters}


def test_nfais2_verification_pays_residual_passes_only_when_firing():
    _, tcfg = _cfgs("nfais2", "hybrid", True)
    tops.reset_pass_counts()
    r = tfp.solve_single(tcfg, make_rhs(N, seed=0), device="cpu")
    assert r.converged
    assert 1 <= tops.PASS_COUNTS["residual"] < r.outer_iters


def test_max_outer_exhaustion_reports_unconverged():
    _, tcfg = _cfgs("pfait", "jacobi", True)
    tcfg = tfp.SolverConfig(**{**tcfg.__dict__, "max_outer": 5})
    r = tfp.solve_single(tcfg, make_rhs(N, seed=0), device="cpu")
    assert not r.converged and r.outer_iters == 5
    assert not np.isfinite(float(r.residual))
