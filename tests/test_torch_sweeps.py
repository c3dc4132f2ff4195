"""The port's stencil, rhs and plain sweeps against the JAX package's.

Tolerances: f64 atol 1e-12 (the same arithmetic in the same order); f32
rtol 1e-5, as tests/test_fused.py holds the f32 kernel to its oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solvers import gauss_seidel as jgs
from repro.solvers import jacobi as jjac
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.convdiff import make_rhs as jmake_rhs
from repro_torch import interop
from repro_torch.solvers import gauss_seidel as tgs
from repro_torch.solvers import jacobi as tjac
from repro_torch.solvers.convdiff import Stencil, make_rhs

SHAPE = (5, 6, 7)


def _tol(dtype):
    return dict(atol=1e-12, rtol=0) if dtype == np.float64 else dict(rtol=1e-5, atol=1e-5)


def _inputs(dtype, seed=0, n=8):
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 0.5, -0.3), rho=0.9)
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(tuple(s + 2 for s in SHAPE)).astype(dtype)
    b = rng.standard_normal(SHAPE).astype(dtype)
    return st_j, interop.stencil_from(st_j), g, b


@pytest.mark.parametrize("n,rho", [(8, 0.9), (20, 0.95), (185, 0.95)])
def test_stencil_matches_jax(n, rho):
    a = (1.0, 1.0, 1.0)
    j = JStencil.for_contraction(n, 1.0, a, rho)
    t = Stencil.for_contraction(n, 1.0, a, rho)
    assert t.coefs == (j.diag, j.xm, j.xp, j.ym, j.yp, j.zm, j.zp)
    assert Stencil.convdiff(n, 0.5, a, 0.01) == interop.stencil_from(
        JStencil.convdiff(n, 0.5, a, 0.01))


@pytest.mark.parametrize("kind", ["smooth", "const"])
def test_make_rhs_matches_jax(kind):
    np.testing.assert_array_equal(make_rhs(9, seed=3, kind=kind),
                                  jmake_rhs(9, seed=3, kind=kind))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jacobi_functions_match_jax(dtype):
    st_j, st, g, b = _inputs(dtype)
    gj, bj, gt, bt = jnp.asarray(g), jnp.asarray(b), torch.as_tensor(g), torch.as_tensor(b)
    tol = _tol(dtype)
    np.testing.assert_allclose(tjac.offdiag_apply(st, gt).numpy(),
                               np.asarray(jjac.offdiag_apply(st_j, gj)), **tol)
    np.testing.assert_allclose(tjac.jacobi_sweep(st, gt, bt).numpy(),
                               np.asarray(jjac.jacobi_sweep(st_j, gj, bj)), **tol)
    new_t, r_t = tjac.jacobi_sweep_residual(st, gt, bt)
    new_j, r_j = jjac.jacobi_sweep_residual(st_j, gj, bj)
    assert new_t.dtype == torch.from_numpy(g).dtype
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), **tol)
    # the residual is O(diag · |x|): compare relative to its scale
    scale = float(np.abs(np.asarray(r_j)).max())
    np.testing.assert_allclose(r_t.numpy() / scale, np.asarray(r_j) / scale, **tol)
    np.testing.assert_allclose(tjac.residual_block(st, gt, bt).numpy() / scale,
                               np.asarray(jjac.residual_block(st_j, gj, bj)) / scale,
                               **tol)


@pytest.mark.parametrize("phase", [(0, 0, 0), (3, 5, 0), (1, 0, 1), (2, 3, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_redblack_gs_matches_jax(dtype, phase):
    ox, oy, oz = phase
    st_j, st, g, b = _inputs(dtype, seed=1)
    gt, bt = torch.as_tensor(g), torch.as_tensor(b)
    new_t, r_t = tgs.redblack_gs_sweep_residual(st, gt, bt, ox, oy, oz)
    new_j, r_j = jgs.redblack_gs_sweep_residual(st_j, jnp.asarray(g), jnp.asarray(b),
                                                ox, oy, oz)
    tol = _tol(dtype)
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), **tol)
    scale = float(np.abs(np.asarray(r_j)).max())
    np.testing.assert_allclose(r_t.numpy() / scale, np.asarray(r_j) / scale, **tol)
    np.testing.assert_array_equal(
        tgs.redblack_gs_sweep(st, gt, bt, ox, oy, oz).numpy(), new_t.numpy())
    np.testing.assert_array_equal(tgs.parity_mask(SHAPE, ox, oy, oz).numpy(),
                                  np.asarray(jgs.parity_mask(SHAPE, ox, oy, oz)))
    # the sweep does not modify its input
    np.testing.assert_array_equal(gt.numpy(), g)


def test_wrong_phase_changes_the_sweep():
    """A checkerboard off by one still relaxes, so only a trajectory check
    sees it: the two phases must give different blocks."""
    _, st, g, b = _inputs(np.float64, seed=2)
    gt, bt = torch.as_tensor(g), torch.as_tensor(b)
    a = tgs.redblack_gs_sweep(st, gt, bt, 0, 0)
    c = tgs.redblack_gs_sweep(st, gt, bt, 1, 0)
    assert not torch.allclose(a, c)
    torch.testing.assert_close(a, tgs.redblack_gs_sweep(st, gt, bt, 3, 5), rtol=0, atol=0)
