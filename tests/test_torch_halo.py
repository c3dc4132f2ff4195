"""The halo-consuming sweeps of the port against the JAX package.

On the CPU the halo wrappers run their plain versions (``ghosted6`` and the
ghosted plain sweeps), so these tests hold the plain versions and the three
``ops`` halo entries to the JAX ops ``sweep_halo`` /
``sweep_with_contribution_halo`` / ``residual_contribution_halo``, whose
off-TPU path is ``ghosted6`` plus the jnp solvers, and to the JAX oracles
(``ref.fused_sweep_residual_halo_ref``,
``gauss_seidel.redblack_gs_sweep_residual`` with the phase ox, oy, oz).
Pallas interpret mode is not used: it cannot run on the installed JAX.

Tolerances (as in ``test_torch_kernels.py``): blocks f64 1e-12 and f32
1e-5 relative to the largest magnitude; partials and contributions f64
1e-6 and f32 1e-5 (f32 sums in another order).  On a block the tile does
not divide, the JAX partials layout needs divisibility, so the reduced
contribution is compared with the JAX ops run with the whole block as one
tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import residual as jres
from repro.kernels.jacobi3d import ops as jops
from repro.kernels.jacobi3d import ref as jref
from repro.solvers import gauss_seidel as jgs
from repro.solvers import jacobi as jjac
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.fixed_point import ghosted6 as jghosted6
from repro_torch import interop
from repro_torch.kernels.jacobi3d import jacobi3d as tk
from repro_torch.kernels.jacobi3d import ops as tops
from repro_torch.kernels.jacobi3d import ref as tref
from repro_torch.solvers import gauss_seidel as tgs
from repro_torch.solvers.fixed_point import ghosted6

INF = float("inf")
_ORD = {True: INF, False: 2.0}   # the port's order for a JAX ``linf`` flag
PHASES = [(0, 0, 0), (3, 1, 2)]
DTYPES = [np.float64, np.float32]


def _stencil(n=8):
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    return st_j, interop.stencil_from(st_j)


def _halo_block(shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    bx, by, bz = shape
    x = rng.standard_normal(shape).astype(dtype)
    halos = tuple(rng.standard_normal(s).astype(dtype) for s in
                  ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by)))
    b = rng.standard_normal(shape).astype(dtype)
    return x, halos, b


def _t(a):
    return tuple(torch.as_tensor(v) for v in a) if isinstance(a, tuple) else torch.as_tensor(a)


def _j(a):
    return tuple(jnp.asarray(v) for v in a) if isinstance(a, tuple) else jnp.asarray(a)


def _close_rel(got, want, rtol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, want / scale,
                               rtol=0, atol=rtol)


def _tols(dtype):
    return (1e-12, 1e-6) if dtype == np.float64 else (1e-5, 1e-5)


def test_ghosted6_matches_jax():
    x, halos, _ = _halo_block((5, 6, 7))
    np.testing.assert_array_equal(ghosted6(_t(x), _t(halos)).numpy(),
                                  np.asarray(jghosted6(_j(x), _j(halos))))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("linf", [True, False])
@pytest.mark.parametrize("op", ["sweep", "residual"])
def test_halo_sweep_plain_matches_jax(op, linf, dtype):
    st_j, st = _stencil()
    x, halos, b = _halo_block((8, 8, 6), seed=1, dtype=dtype)
    new, parts = tk.fused_sweep_residual_halo(_t(x), _t(halos), _t(b), st.coefs,
                                              tile=(4, 4), op=op, ord=_ORD[linf])
    want = tref.fused_sweep_residual_halo_ref(_t(x), _t(halos), _t(b), st.coefs,
                                              tile=(4, 4), op=op, ord=_ORD[linf])
    assert torch.equal(new, want[0]) and torch.equal(parts, want[1])
    coefs = jnp.asarray(st.coefs, jnp.asarray(b).dtype)
    jnew, jparts = jref.fused_sweep_residual_halo_ref(_j(x), _j(halos), _j(b), coefs,
                                                      tile=(4, 4), op=op, linf=linf)
    btol, ptol = _tols(dtype)
    _close_rel(new.numpy(), jnew, btol)
    _close_rel(parts.numpy(), jparts, ptol)
    assert parts.shape == (2, 2) and parts.dtype == torch.float32
    assert tk.LAUNCHES["fused_sweep_residual_halo"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("linf", [True, False])
def test_halo_rbgs_plain_matches_jax(linf, phase, dtype):
    st_j, st = _stencil()
    x, halos, b = _halo_block((8, 8, 6), seed=2, dtype=dtype)
    new, parts = tk.fused_rbgs_sweep_residual_halo(_t(x), _t(halos), _t(b), st.coefs,
                                                   sum(phase), tile=(4, 4), ord=_ORD[linf])
    own, r = tgs.redblack_gs_sweep_residual(st, ghosted6(_t(x), _t(halos)), _t(b), *phase)
    assert torch.equal(new, own)
    assert torch.equal(parts, tref.residual_partials(r, tile=(4, 4), ord=_ORD[linf]))
    jnew, jr = jgs.redblack_gs_sweep_residual(st_j, jghosted6(_j(x), _j(halos)), _j(b),
                                              *phase)
    btol, ptol = _tols(dtype)
    _close_rel(new.numpy(), jnew, btol)
    _close_rel(parts.numpy(), jref.residual_partials(jr, tile=(4, 4), linf=linf), ptol)
    assert tk.LAUNCHES["fused_rbgs_sweep_residual_halo"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ord", [INF, 2.0])
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("sweep", ["jacobi", "hybrid"])
def test_halo_ops_match_jax_ops(sweep, phase, ord, dtype):
    st_j, st = _stencil()
    x, halos, b = _halo_block((8, 8, 6), seed=3, dtype=dtype)
    ph = dict(zip(("ox", "oy", "oz"), phase))
    tops.reset_pass_counts()
    new, c = tops.sweep_with_contribution_halo(st, _t(x), _t(halos), _t(b), sweep=sweep,
                                               ord=ord, tile=(4, 4), **ph)
    jnew, jc = jops.sweep_with_contribution_halo(st_j, _j(x), _j(halos), _j(b),
                                                 sweep=sweep, ord=ord, tile=(4, 4), **ph)
    btol, ctol = _tols(dtype)
    _close_rel(new.numpy(), jnew, btol)
    np.testing.assert_allclose(float(c), float(jc), rtol=ctol)
    only = tops.sweep_halo(st, _t(x), _t(halos), _t(b), sweep=sweep, **ph)
    assert torch.equal(only, new)
    _close_rel(only.numpy(), jops.sweep_halo(st_j, _j(x), _j(halos), _j(b), sweep=sweep,
                                             **ph), btol)
    rc = tops.residual_contribution_halo(st, _t(x), _t(halos), _t(b), ord=ord,
                                         tile=(4, 4))
    jrc = jops.residual_contribution_halo(st_j, _j(x), _j(halos), _j(b), ord=ord,
                                          tile=(4, 4))
    np.testing.assert_allclose(float(rc), float(jrc), rtol=ctol)
    assert tops.PASS_COUNTS == {"sweep": 1, "fused": 1, "residual": 1}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ord", [INF, 2.0])
@pytest.mark.parametrize("sweep", ["jacobi", "hybrid"])
def test_halo_ops_contribution_on_ragged_block(sweep, ord, dtype):
    """The default tile on a block it does not divide: the reduced
    contribution equals the JAX ops' with the whole block as one tile."""
    st_j, st = _stencil()
    shape = (13, 37, 5)
    x, halos, b = _halo_block(shape, seed=4, dtype=dtype)
    ph = dict(ox=3, oy=1, oz=2)
    new, c = tops.sweep_with_contribution_halo(st, _t(x), _t(halos), _t(b), sweep=sweep,
                                               ord=ord, **ph)
    jnew, jc = jops.sweep_with_contribution_halo(st_j, _j(x), _j(halos), _j(b),
                                                 sweep=sweep, ord=ord, tile=shape[:2],
                                                 **ph)
    btol, ctol = _tols(dtype)
    _close_rel(new.numpy(), jnew, btol)
    np.testing.assert_allclose(float(c), float(jc), rtol=ctol)
    rc = tops.residual_contribution_halo(st, _t(x), _t(halos), _t(b), ord=ord)
    jr = jjac.residual_block(st_j, jghosted6(_j(x), _j(halos)), _j(b))
    jrc = jnp.max(jnp.abs(jr)) if np.isinf(ord) else jnp.sum(jr * jr)
    np.testing.assert_allclose(float(rc), float(jrc), rtol=ctol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sweep", ["jacobi", "hybrid", "residual"])
def test_halo_l1_matches_jax_local_contribution(sweep, dtype):
    """ord 1: the plain halo versions' partials, and the ops' reduced
    contribution, are JAX ``local_contribution(r, 1)`` of the input
    residual (Σ f32|r|) — not what the JAX halo ops return at ord 1, which
    is Σr² (they pick Σr² for every finite order)."""
    st_j, st = _stencil()
    shape = (9, 10, 6)
    x, halos, b = _halo_block(shape, seed=5, dtype=dtype)
    ph = dict(ox=3, oy=1, oz=2)
    g = jghosted6(_j(x), _j(halos))
    if sweep == "hybrid":
        _, parts = tk.fused_rbgs_sweep_residual_halo(_t(x), _t(halos), _t(b), st.coefs, 6,
                                                     tile=(4, 4), ord=1.0)
        _, c = tops.sweep_with_contribution_halo(st, _t(x), _t(halos), _t(b), sweep=sweep,
                                                 ord=1.0, **ph)
        _, r = jgs.redblack_gs_sweep_residual(st_j, g, _j(b), 3, 1, 2)
    else:
        op = "sweep" if sweep == "jacobi" else "residual"
        _, parts = tk.fused_sweep_residual_halo(_t(x), _t(halos), _t(b), st.coefs,
                                                tile=(4, 4), op=op, ord=1.0)
        c = tops.residual_contribution_halo(st, _t(x), _t(halos), _t(b), ord=1.0) \
            if op == "residual" else tops.sweep_with_contribution_halo(
                st, _t(x), _t(halos), _t(b), sweep=sweep, ord=1.0, **ph)[1]
        r = jjac.residual_block(st_j, g, _j(b))
    _, ctol = _tols(dtype)
    r = np.asarray(r)
    assert parts.shape == (3, 3)
    for i in range(3):
        for j in range(3):
            want = jres.local_contribution(jnp.asarray(r[4 * i:4 * i + 4, 4 * j:4 * j + 4]), 1)
            np.testing.assert_allclose(parts[i, j].item(), float(want), rtol=ctol)
    np.testing.assert_allclose(float(c), float(jres.local_contribution(jnp.asarray(r), 1)),
                               rtol=ctol)


def test_halo_planes_are_validated_and_cast():
    _, st = _stencil()
    x, halos, b = _halo_block((4, 5, 6))
    xt, ht, bt = _t(x), _t(halos), _t(b)
    with pytest.raises(ValueError, match="six face planes"):
        tk.fused_sweep_residual_halo(xt, ht[:5], bt, st.coefs)
    with pytest.raises(ValueError, match=r"gym has shape \(5, 6\), want \(4, 6\)"):
        tk.fused_sweep_residual_halo(xt, ht[:2] + (ht[0],) + ht[3:], bt, st.coefs)
    with pytest.raises(TypeError, match="gzp must be floating"):
        tk.fused_rbgs_sweep_residual_halo(xt, ht[:5] + (ht[5].long(),), bt, st.coefs, 0)
    with pytest.raises(ValueError, match="op"):
        tk.fused_sweep_residual_halo(xt, ht, bt, st.coefs, op="norm")
    # f32 planes are cast to the f64 block, as the JAX wrapper does
    h32 = tuple(h.float() for h in ht)
    for fn in (lambda h: tk.fused_sweep_residual_halo(xt, h, bt, st.coefs),
               lambda h: tk.fused_rbgs_sweep_residual_halo(xt, h, bt, st.coefs, 1)):
        got, want = fn(h32), fn(tuple(h.double() for h in h32))
        assert got[0].dtype == torch.float64
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
