"""The port's 2-D/3-D mesh shard runtime against the JAX package's.

* Config validation raises what the JAX runtime raises
  (``tests/test_mesh_runtime.py``'s validation matrix).
* 1-shard meshes (1,), (1, 1), (1, 1, 1) — overlap on where the reduction
  allows it — against the JAX runtime on a 1-device mesh of the same shape.
* Overlap against no overlap on a (2, 2) mesh with heterogeneous per-shard
  knobs: ``torch.equal`` on x and on the trace.
* p > 1: one JAX program in a subprocess with 8 forced host devices runs
  the mesh runtime on (2, 2), (2, 1, 2), (2, 2, 2), (4, 2) and (1, 2, 4)
  meshes and the 1-D runtime at p = 4 and p = 8, across the reductions,
  sweeps and detection modes, with heterogeneous knobs, and the 1-D
  runtime at ord 1 (l1); the port on the stacked CPU transport must take
  the same outer iterations, with finite trace entries within rtol 5e-5 and
  x within atol 1e-10.  Heterogeneous knobs index shards by rank, so a rank
  order other than JAX's row-major one fails here.
* ord 1 on a mesh: the JAX mesh runtime reduces Σr² partials as l1 there
  (its halo ops pick Σr² for every finite order), so the port's mesh runs
  at ord 1 are held instead to JAX ``convdiff_reference_trace(ord=1)``, to
  the JAX 1-D runtime and to the exact l1 residual of their result.

The bars are those of ``test_torch_shard_runtime.py``: the port sums
per-tile f32 partials where the JAX runtime sums whole blocks.
"""
import os
import subprocess
import sys
import textwrap
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
from repro_torch.runtime import shard_runtime as tsr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")
EPS_TILDE = 1e-6
HET4 = dict(inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 2, 1), contrib_lag=(0, 1, 0, 1))
HET8 = dict(inner_sweeps=(1, 2, 1, 3, 2, 1, 1, 2), halo_delay=(0, 1, 2, 1, 0, 2, 1, 0),
            contrib_lag=(0, 1, 0, 1, 1, 0, 0, 1))


def _jmon(mode, ord=INF):
    if mode == "sync":
        return jdet.MonitorConfig(mode="sync", eps=1e-7, staleness=0, ord=ord)
    return jdet.for_mode(mode, eps_tilde=EPS_TILDE, margin=10.0, staleness=2,
                         persistence=4, ord=ord)


def _mon():
    return tdet.MonitorConfig(mode="sync", eps=1e-7)


def _assert_same_run(got, want):
    """``want`` holds the JAX run's arrays (numpy)."""
    assert got.converged and bool(want["converged"])
    assert got.outer_iters == int(want["outer_iters"])
    assert got.verifications == int(want["verifications"])
    np.testing.assert_array_equal(got.local_sweeps, np.asarray(want["local_sweeps"]))
    trace, jtrace = got.trace.numpy(), np.asarray(want["trace"])
    fin = np.isfinite(jtrace)
    np.testing.assert_array_equal(np.isfinite(trace), fin)
    np.testing.assert_allclose(trace[fin], jtrace[fin], rtol=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want["x"]), atol=1e-10, rtol=0)


# ---------------------------------------------------------------------------
# Config validation (parity with tests/test_mesh_runtime.py)
# ---------------------------------------------------------------------------


def _raises_same(fn_j, fn_t, exc=ValueError):
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [dict(mesh_shape=(2, 2, 2, 2)), dict(mesh_shape=(2, 0)),
                                dict(sweep="hybrid", overlap=True),
                                dict(reduction="blocking", overlap=True)])
def test_config_validation_matches_jax(kw):
    jm = jdet.MonitorConfig(mode="sync", eps=1e-7)
    _raises_same(lambda: jsr.ShardRuntimeConfig(monitor=jm, **kw),
                 lambda: tsr.ShardRuntimeConfig(monitor=_mon(), **kw))


def test_config_normalises_mesh_shape():
    cfg = tsr.ShardRuntimeConfig(monitor=_mon(), mesh_shape=[2, 2])
    assert cfg.mesh_shape == (2, 2)
    assert tsr.ShardRuntimeConfig(monitor=_mon()).mesh_shape is None


def _fake_mesh(shape):
    names = ("shard_x", "shard_y", "shard_z")[:len(shape)]
    return types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


@pytest.mark.parametrize("n,shape,kw", [
    (8, (2, 2), dict(inner_sweeps=(1, 2))),             # names the mesh shape
    (8, (2, 2, 2), dict(halo_delay=(0, 1, 2, 1))),
    (2, (2, 1), dict(overlap=True)),                     # block extent 1
    (8, (2, 2), dict(reduction="rdoubling", contrib_lag=-1)),
])
def test_runtime_validation_matches_jax(n, shape, kw):
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    jcfg = jsr.ShardRuntimeConfig(monitor=jdet.MonitorConfig(mode="sync", eps=1e-7),
                                  mesh_shape=shape, **kw)
    tcfg = interop.shard_config_from(jcfg)
    _raises_same(lambda: jsr.make_convdiff_runtime(jcfg, _fake_mesh(shape), st_j, n),
                 lambda: tsr.make_convdiff_runtime(tcfg, shape, interop.stencil_from(st_j),
                                                   n, device="cpu"))


def test_runtime_refuses_what_its_mesh_cannot_run():
    st = interop.stencil_from(JStencil.for_contraction(8, 1.0, (1.0, 1.0, 1.0), 0.9))
    with pytest.raises(ValueError, match="does not match"):
        tsr.make_convdiff_runtime(tsr.ShardRuntimeConfig(monitor=_mon(), mesh_shape=(2, 1)),
                                  (2, 2), st, 8, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tsr.make_convdiff_runtime(tsr.ShardRuntimeConfig(monitor=_mon(), mesh_shape=(4,)),
                                  2, st, 8, device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        tsr.make_convdiff_runtime(tsr.ShardRuntimeConfig(monitor=_mon(), reduction="rdoubling"),
                                  (3, 2), st, 12, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tsr.make_convdiff_runtime(tsr.ShardRuntimeConfig(monitor=_mon()), (3, 2), st, 8,
                                  device="cpu")
    with pytest.raises(ValueError, match="ord"):
        tsr.make_convdiff_runtime(
            tsr.ShardRuntimeConfig(monitor=tdet.MonitorConfig(ord=3.0)), (2, 2), st, 8,
            device="cpu")


# ---------------------------------------------------------------------------
# 1-shard meshes against the JAX runtime on a 1-device mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction,sweep,mode,overlap", [
    ("nonblocking", "jacobi", "pfait", True),
    ("rdoubling", "jacobi", "pfait", True),
    ("blocking", "jacobi", "sync", False),
    ("nonblocking", "hybrid", "nfais2", False),
])
@pytest.mark.parametrize("shape", [(1,), (1, 1), (1, 1, 1)])
def test_one_shard_mesh_matches_jax(shape, reduction, sweep, mode, overlap):
    n = 8
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = make_rhs(n, seed=0)
    jcfg = jsr.ShardRuntimeConfig(monitor=_jmon(mode), reduction=reduction, sweep=sweep,
                                  max_outer=600, trace_len=64, mesh_shape=shape,
                                  overlap=overlap)
    want = jax.jit(jsr.make_convdiff_runtime(jcfg, make_shard_mesh(shape), st_j, n))(
        jnp.zeros((n, n, n)), jnp.asarray(b))
    got = tsr.make_convdiff_runtime(interop.shard_config_from(jcfg), shape,
                                    interop.stencil_from(st_j), n, device="cpu")(
        np.zeros((n, n, n)), b)
    _assert_same_run(got, {k: np.asarray(v) for k, v in want._asdict().items()})
    assert float(got.residual) == pytest.approx(float(want.residual), rel=1e-5)


# ---------------------------------------------------------------------------
# ord 1 (l1) on a mesh: the exact l1 residual, never JAX's mesh runtime
# ---------------------------------------------------------------------------


def _exact_l1(st_j, x, b) -> float:
    """Σ|b − A x| of a returned global state, by the JAX reference."""
    xj = jnp.asarray(x.numpy())
    r = jjac.residual_block(st_j, ghosted(xj, _zero_ghosts(xj)), jnp.asarray(b))
    return float(jnp.sum(jnp.abs(r)))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_l1_blocking_mesh_matches_reference_trace(shape):
    """ROADMAP Queue 3's l1 case (n = 8, ρ = 0.9, blocking, sync, ε 1e-7,
    ord 1): the JAX 1-D runtime converges in 127 iterations, and so must the
    port's mesh, following JAX ``convdiff_reference_trace(ord=1)`` and the
    JAX 1-D runtime's trace and state; its detected residual is the exact l1
    residual of its result."""
    n = 8
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = make_rhs(n, seed=0)
    jcfg = jsr.ShardRuntimeConfig(monitor=_jmon("sync", 1.0), reduction="blocking",
                                  max_outer=600, trace_len=256)
    want = jax.jit(jsr.make_convdiff_runtime(jcfg, make_shard_mesh(1), st_j, n))(
        jnp.zeros((n, n, n)), jnp.asarray(b))
    got = tsr.make_convdiff_runtime(interop.shard_config_from(jcfg), shape,
                                    interop.stencil_from(st_j), n, device="cpu")(
        np.zeros((n, n, n)), b)
    assert int(want.outer_iters) == 127
    assert got.converged and got.outer_iters == 127
    T = got.outer_iters
    ref = np.asarray(jsr.convdiff_reference_trace(st_j, jnp.asarray(b), T, ord=1.0))
    np.testing.assert_allclose(got.trace.numpy()[:T], ref, rtol=5e-5)
    np.testing.assert_allclose(got.trace.numpy()[:T], np.asarray(want.trace)[:T], rtol=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)
    assert float(got.residual) == pytest.approx(_exact_l1(st_j, got.x, b), rel=5e-5)


@pytest.mark.parametrize("shape,sweep,mode", [((2, 2), "jacobi", "nfais2"),
                                              ((2, 1, 2), "hybrid", "pfait")])
def test_l1_async_mesh_detects_truthfully(shape, sweep, mode):
    """Non-blocking meshes at ord 1 with heterogeneous knobs: the exact l1
    residual of the result is under ε̃ (no false detection)."""
    n, eps_tilde = 12, 1e-4
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = make_rhs(n, seed=0)
    mon = tdet.for_mode(mode, eps_tilde=eps_tilde, margin=10.0, staleness=2,
                        persistence=4, ord=1.0)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, sweep=sweep, max_outer=2000, **HET4)
    r = tsr.make_convdiff_runtime(cfg, shape, interop.stencil_from(st_j), n,
                                  device="cpu")(np.zeros_like(b), b)
    assert r.converged
    assert _exact_l1(st_j, r.x, b) < eps_tilde


# ---------------------------------------------------------------------------
# Overlap is bitwise no overlap
# ---------------------------------------------------------------------------


def test_overlap_bitwise_equals_no_overlap():
    n = 12
    st = interop.stencil_from(JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9))
    b = make_rhs(n, seed=1)
    mon = tdet.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, staleness=2,
                        persistence=4, ord=INF)
    runs = [tsr.make_convdiff_runtime(
        tsr.ShardRuntimeConfig(monitor=mon, max_outer=2000, trace_len=64, overlap=ov,
                               mesh_shape=(2, 2), **HET4),
        (2, 2), st, n, device="cpu")(np.zeros_like(b), b) for ov in (False, True)]
    r0, r1 = runs
    assert r0.converged and r1.converged and r0.outer_iters == r1.outer_iters
    assert torch.equal(r0.x, r1.x) and torch.equal(r0.trace, r1.trace)
    k = r1.outer_iters
    assert list(r1.local_sweeps) == [k, 2 * k, k, 3 * k]


# ---------------------------------------------------------------------------
# p > 1: the port against the JAX runtime on 8 forced host devices
# ---------------------------------------------------------------------------

N_MULTI = 16
RUNS = {
    "2x2-jacobi-overlap": dict(shape=(2, 2), reduction="nonblocking", sweep="jacobi",
                               overlap=True, mode="pfait", knobs=HET4),
    "2x2-hybrid": dict(shape=(2, 2), reduction="nonblocking", sweep="hybrid",
                       mode="pfait", knobs=HET4),
    "2x1x2-jacobi-overlap": dict(shape=(2, 1, 2), reduction="nonblocking",
                                 sweep="jacobi", overlap=True, mode="pfait", knobs=HET4),
    "2x2x2-hybrid": dict(shape=(2, 2, 2), reduction="nonblocking", sweep="hybrid",
                         mode="nfais2", knobs=HET8),
    "2x2x2-rdoubling": dict(shape=(2, 2, 2), reduction="rdoubling", sweep="jacobi",
                            mode="pfait", knobs=HET8),
    "2x2-blocking": dict(shape=(2, 2), reduction="blocking", sweep="jacobi", mode="sync",
                         knobs={}),
    "p4-jacobi": dict(shape=4, reduction="nonblocking", sweep="jacobi", mode="pfait",
                      knobs=HET4),
    "p4-hybrid": dict(shape=4, reduction="nonblocking", sweep="hybrid", mode="pfait",
                      knobs=HET4),
    # twelve more configurations across reductions, sweeps, modes and meshes
    "p4-rdoubling": dict(shape=4, reduction="rdoubling", sweep="jacobi", mode="pfait",
                         knobs=HET4),
    "p4-blocking": dict(shape=4, reduction="blocking", sweep="jacobi", mode="sync",
                        knobs={}),
    "p4-blocking-hybrid": dict(shape=4, reduction="blocking", sweep="hybrid", mode="sync",
                               knobs={}),
    "p4-nfais5": dict(shape=4, reduction="nonblocking", sweep="jacobi", mode="nfais5",
                      knobs=HET4),
    "p4-hybrid-nfais2": dict(shape=4, reduction="nonblocking", sweep="hybrid",
                             mode="nfais2", knobs=HET4),
    "p4-rdoubling-hybrid-nfais2": dict(shape=4, reduction="rdoubling", sweep="hybrid",
                                       mode="nfais2", knobs=HET4),
    "p8-jacobi": dict(shape=8, reduction="nonblocking", sweep="jacobi", mode="pfait",
                      knobs=HET8),
    "2x2-nfais5": dict(shape=(2, 2), reduction="nonblocking", sweep="jacobi",
                       mode="nfais5", knobs=HET4),
    "2x2-rdoubling-hybrid": dict(shape=(2, 2), reduction="rdoubling", sweep="hybrid",
                                 mode="pfait", knobs=HET4),
    "2x2-blocking-hybrid": dict(shape=(2, 2), reduction="blocking", sweep="hybrid",
                                mode="sync", knobs={}),
    "4x2-overlap-nfais2": dict(shape=(4, 2), reduction="nonblocking", sweep="jacobi",
                               overlap=True, mode="nfais2", knobs=HET8),
    "1x2x4-hybrid": dict(shape=(1, 2, 4), reduction="nonblocking", sweep="hybrid",
                         mode="pfait", knobs=HET8),
    # l1: the JAX 1-D runtime (its contributions are local_contribution(·, 1))
    "p4-jacobi-l1": dict(shape=4, reduction="nonblocking", sweep="jacobi", mode="pfait",
                         knobs=HET4, ord=1.0),
    "p4-blocking-l1": dict(shape=4, reduction="blocking", sweep="jacobi", mode="sync",
                           knobs={}, ord=1.0),
}


def _jax_config(run):
    """The JAX config of a run (the subprocess builds the same one)."""
    shape = run["shape"]
    return jsr.ShardRuntimeConfig(
        monitor=_jmon(run["mode"], run.get("ord", INF)), reduction=run["reduction"],
        sweep=run["sweep"],
        max_outer=2000, trace_len=64, overlap=run.get("overlap", False),
        mesh_shape=tuple(shape) if isinstance(shape, tuple) else None, **run["knobs"])


_PROGRAM = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.join(sys.argv[3], "tests"))
    import test_torch_mesh_runtime as t
    from repro.launch.mesh import make_shard_mesh
    from repro.runtime import shard_runtime as sr
    from repro.solvers.convdiff import Stencil, make_rhs

    n = int(sys.argv[2])
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = jnp.asarray(make_rhs(n, seed=0))
    out = {}
    for name, run in t.RUNS.items():
        mesh = make_shard_mesh(run["shape"])
        r = jax.jit(sr.make_convdiff_runtime(t._jax_config(run), mesh, st, n))(
            jnp.zeros_like(b), b)
        for k, v in r._asdict().items():
            out[name + "/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("JAX_MESH_RUNS_OK", len(t.RUNS))
""")


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    """The JAX runs of ``RUNS``, from one subprocess on 8 host devices."""
    path = tmp_path_factory.mktemp("jax_mesh") / "runs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROGRAM, str(path), str(N_MULTI), REPO],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_MESH_RUNS_OK" in out.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(RUNS))
def test_multi_shard_matches_jax(jax_multi, name):
    run = RUNS[name]
    n = N_MULTI
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = make_rhs(n, seed=0)
    tcfg = interop.shard_config_from(_jax_config(run))
    assert tcfg.mesh_shape == (run["shape"] if isinstance(run["shape"], tuple) else None)
    got = tsr.make_convdiff_runtime(tcfg, run["shape"], interop.stencil_from(st_j), n,
                                    device="cpu")(np.zeros_like(b), b)
    want = {k.split("/", 1)[1]: v for k, v in jax_multi.items()
            if k.startswith(name + "/")}
    _assert_same_run(got, want)
