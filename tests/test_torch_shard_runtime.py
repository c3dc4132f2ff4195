"""The port's stacked shard runtime against the JAX package's shard runtime.

* p = 1: the port against JAX ``make_convdiff_runtime`` on a 1-shard mesh,
  per reduction (same outer iterations, detected residual within rel 1e-5,
  trace within rtol 5e-5, x within atol 1e-10).  The port routes every
  contribution through the kernel ops, which sum per-tile f32 partials
  where the JAX runtime sums the whole block: that is the f32-sum
  tolerance these bars allow for.
* p = 4 stacked: blocking follows JAX ``convdiff_reference_trace`` at
  rtol 5e-5; non-blocking with heterogeneous knobs and recursive doubling
  detect with no false detection (exact residual of the result under ε̃).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.launch.mesh import make_shard_mesh
from repro.runtime import shard_runtime as jsr
from repro.solvers import jacobi as jjac
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.convdiff import make_rhs
from repro.solvers.fixed_point import _zero_ghosts, ghosted
from repro_torch import interop
from repro_torch.core import detection as tdet
from repro_torch.kernels.jacobi3d import ops as tops
from repro_torch.runtime import shard_runtime as tsr
from repro_torch.runtime.transport import StackedTransport

INF = float("inf")
EPS_TILDE = 1e-6


def _setup(n, seed=0, rho=0.9):
    st = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=rho)
    return st, interop.stencil_from(st), make_rhs(n, seed=seed)


def _exact_linf(st_j, x, b) -> float:
    """max|b − A x| of a returned global state, by the JAX reference."""
    xj = jnp.asarray(x.numpy())
    r = jjac.residual_block(st_j, ghosted(xj, _zero_ghosts(xj)), jnp.asarray(b))
    return float(jnp.max(jnp.abs(r)))


@pytest.mark.parametrize("reduction,sweep,mode", [
    ("blocking", "jacobi", "sync"),
    ("nonblocking", "jacobi", "pfait"),
    ("nonblocking", "hybrid", "nfais2"),
    ("rdoubling", "jacobi", "pfait"),
])
def test_single_shard_matches_jax(reduction, sweep, mode):
    n = 8
    st_j, st, b = _setup(n)
    mon = jdet.for_mode(mode, eps_tilde=EPS_TILDE, margin=10.0, staleness=2,
                        persistence=3, ord=INF)
    jcfg = jsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, sweep=sweep,
                                  max_outer=600, trace_len=64)
    want = jax.jit(jsr.make_convdiff_runtime(jcfg, make_shard_mesh(1), st_j, n))(
        jnp.zeros((n, n, n)), jnp.asarray(b))
    tcfg = interop.shard_config_from(jcfg)
    got = tsr.make_convdiff_runtime(tcfg, 1, st, n, device="cpu")(np.zeros((n, n, n)), b)
    assert got.converged == bool(want.converged) is True
    assert got.outer_iters == int(want.outer_iters)
    assert got.verifications == int(want.verifications)
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), rtol=5e-5)
    np.testing.assert_array_equal(got.local_sweeps, np.asarray(want.local_sweeps))


@pytest.mark.parametrize("reduction,sweep,mode", [
    ("blocking", "jacobi", "sync"),
    ("nonblocking", "jacobi", "pfait"),
    ("nonblocking", "hybrid", "nfais2"),
    ("rdoubling", "jacobi", "pfait"),
])
def test_single_shard_l1_matches_jax(reduction, sweep, mode):
    """ord 1 at p = 1 against the JAX 1-D runtime, whose contributions are
    ``local_contribution(·, 1)``: the same bars as at l∞.  Blocking is the
    l1 case of ROADMAP Queue 3 (n = 8, ρ = 0.9, sync, ε 1e-7): 127 iterations."""
    n = 8
    st_j, st, b = _setup(n)
    mon = jdet.MonitorConfig(mode="sync", eps=1e-7, ord=1.0) if mode == "sync" else \
        jdet.for_mode(mode, eps_tilde=1e-4, margin=10.0, staleness=2, persistence=3, ord=1.0)
    jcfg = jsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, sweep=sweep,
                                  max_outer=600, trace_len=64)
    want = jax.jit(jsr.make_convdiff_runtime(jcfg, make_shard_mesh(1), st_j, n))(
        jnp.zeros((n, n, n)), jnp.asarray(b))
    got = tsr.make_convdiff_runtime(interop.shard_config_from(jcfg), 1, st, n,
                                    device="cpu")(np.zeros((n, n, n)), b)
    assert got.converged == bool(want.converged) is True
    assert got.outer_iters == int(want.outer_iters)
    if mode == "sync":
        assert got.outer_iters == 127
    assert got.verifications == int(want.verifications)
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.trace.numpy(), np.asarray(want.trace), rtol=5e-5)


def test_stacked_blocking_matches_reference_trace():
    n, p = 12, 4
    st_j, st, b = _setup(n)
    cfg = tsr.ShardRuntimeConfig(monitor=tdet.MonitorConfig(mode="sync", eps=1e-7),
                                 reduction="blocking", max_outer=400, trace_len=256)
    r = tsr.make_convdiff_runtime(cfg, p, st, n, device="cpu")(np.zeros((n, n, n)), b)
    assert r.converged
    T = min(r.outer_iters, 256)
    ref = np.asarray(jsr.convdiff_reference_trace(st_j, jnp.asarray(b), T))
    np.testing.assert_allclose(r.trace.numpy()[:T], ref, rtol=5e-5)
    # the port's own reference agrees with the JAX one
    own = tsr.convdiff_reference_trace(st, torch.as_tensor(b), T).numpy()
    np.testing.assert_allclose(own, ref, rtol=5e-5)


@pytest.mark.parametrize("reduction,sweep,mode", [
    ("nonblocking", "jacobi", "pfait"),
    ("nonblocking", "hybrid", "pfait"),
    ("nonblocking", "jacobi", "nfais2"),
    ("rdoubling", "jacobi", "pfait"),
    ("rdoubling", "hybrid", "pfait"),
])
def test_stacked_async_modes_detect_truthfully(reduction, sweep, mode):
    n, p = 12, 4
    st_j, st, b = _setup(n)
    mon = tdet.for_mode(mode, eps_tilde=EPS_TILDE, margin=10.0, staleness=2,
                        persistence=4, ord=INF)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, sweep=sweep,
                                 max_outer=2000, inner_sweeps=(1, 2, 1, 3),
                                 halo_delay=(0, 1, 2, 1), contrib_lag=(0, 1, 0, 1))
    r = tsr.make_convdiff_runtime(cfg, p, st, n, device="cpu")(np.zeros((n, n, n)), b)
    assert r.converged, (reduction, sweep, mode)
    r_star = _exact_linf(st_j, r.x, b)
    assert r_star < EPS_TILDE, (reduction, sweep, mode, r_star)
    k = r.outer_iters
    assert list(r.local_sweeps) == [k, 2 * k, k, 3 * k]


def test_stacked_runtime_drives_the_kernel_ops():
    n, p = 12, 4
    _, st, b = _setup(n)
    for sweep, want in (("jacobi", {"sweep": 1, "fused": 0}),
                        ("hybrid", {"sweep": 0, "fused": 1})):
        cfg = tsr.ShardRuntimeConfig(monitor=tdet.for_mode("pfait", EPS_TILDE, ord=INF),
                                     sweep=sweep, max_outer=3)
        tops.reset_pass_counts()
        tsr.make_convdiff_runtime(cfg, p, st, n, device="cpu")(np.zeros((n, n, n)), b)
        assert tops.PASS_COUNTS == {k: 3 * p * v for k, v in {**want, "residual": 0}.items()}


def test_butterfly_matches_flat_reduction():
    lanes = dict(enumerate(torch.tensor([3.0, 1.0, 4.0, 1.5])))
    transport = StackedTransport(4, torch.device("cpu"))
    inf = dict.fromkeys(range(4), torch.tensor(INF))
    for ord, flat in ((INF, 4.0), (2.0, 9.5)):
        partial, visible = tsr._butterfly_step(transport, lanes, inf, inf, 0, 2, ord)
        assert all(bool(torch.isinf(v)) for v in visible.values())  # not complete yet
        partial, visible = tsr._butterfly_step(transport, lanes, partial, visible, 1, 2, ord)
        assert [float(visible[i]) for i in range(4)] == [flat] * 4
    assert tsr._butterfly_rounds(1) == 0 and tsr._butterfly_rounds(8) == 3
    with pytest.raises(ValueError, match="power-of-two"):
        tsr._butterfly_rounds(6)


def test_ring_write_read_roundtrip():
    ring = tsr._ring_fill(-1, 3)
    for k in range(5):
        tsr._ring_write(ring, k, k)
    assert [tsr._ring_read(ring, k) for k in (4, 3, 2, -2)] == [4, 3, 2, 3]


def _mon():
    return tdet.MonitorConfig(mode="sync", eps=1e-7)


def test_config_validation():
    with pytest.raises(ValueError, match="reduction"):
        tsr.ShardRuntimeConfig(monitor=_mon(), reduction="psum")
    with pytest.raises(ValueError, match="sweep"):
        tsr.ShardRuntimeConfig(monitor=_mon(), sweep="sor")
    mon = tdet.MonitorConfig(mode="pfait", staleness=3)
    assert tsr.ShardRuntimeConfig(monitor=mon, reduction="blocking").effective_monitor().staleness == 0
    assert tsr.ShardRuntimeConfig(monitor=mon, reduction="rdoubling").effective_monitor().staleness == 0
    assert tsr.ShardRuntimeConfig(monitor=mon).effective_monitor().staleness == 3
    st = interop.stencil_from(JStencil.for_contraction(8, 1.0, (1.0, 1.0, 1.0), 0.9))
    bad = [
        (dict(reduction="blocking", halo_delay=1), "blocking"),
        (dict(inner_sweeps=(1, 2)), "inner_sweeps"),
        (dict(inner_sweeps=0), "inner_sweeps"),
        (dict(contrib_lag=-1), "contrib_lag"),
        (dict(reduction="rdoubling"), "power-of-two"),
    ]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            tsr.make_convdiff_runtime(tsr.ShardRuntimeConfig(monitor=_mon(), **kw), 3,
                                      st, 9, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tsr.make_convdiff_runtime(tsr.ShardRuntimeConfig(monitor=_mon()), 2, st, 9,
                                  device="cpu")
    with pytest.raises(ValueError, match="ord"):
        tsr.make_convdiff_runtime(
            tsr.ShardRuntimeConfig(monitor=tdet.MonitorConfig(ord=3.0)), 2, st, 8,
            device="cpu")


def test_shard_config_from_jax():
    mon = jdet.for_mode("nfais5", eps_tilde=1e-5, staleness=1, persistence=2)
    jcfg = jsr.ShardRuntimeConfig(monitor=mon, reduction="rdoubling",
                                  inner_sweeps=(1, 2), halo_delay=1, trace_len=8,
                                  sweep="hybrid")
    t = interop.shard_config_from(jcfg)
    assert (t.reduction, t.inner_sweeps, t.halo_delay, t.trace_len, t.sweep) == \
        ("rdoubling", (1, 2), 1, 8, "hybrid")
    assert t.monitor == tdet.MonitorConfig(mode="nfais5", eps=1e-5, eps_tilde=1e-5,
                                           staleness=1, persistence=2, ord=2.0)
    assert (t.mesh_shape, t.overlap) == (None, False)
    # the mesh shape and comm overlap are carried across (the port has the
    # mesh runtime); a JAX-side list is normalised to a tuple
    t = interop.shard_config_from(types.SimpleNamespace(**{
        **jcfg.__dict__, "mesh_shape": [2, 2], "overlap": True, "sweep": "jacobi",
        "reduction": "nonblocking"}))
    assert (t.mesh_shape, t.overlap) == ((2, 2), True)
