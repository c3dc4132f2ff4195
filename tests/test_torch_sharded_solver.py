"""The port's ``make_sharded_solver`` against the JAX package's.

JAX runs its solver on a (1, 1) mesh in this process and on a (2, 2) mesh in
one subprocess with 4 forced host devices; the port runs the same configs
(built from the JAX ones with ``repro_torch.interop``) over the stacked
transport and over a spawned gloo world of 4 ranks.  Bars as in the rest
of the suite: equal ``outer_iters`` and ``converged``, ``x`` within atol
1e-10 (f64), the detected residual within rel 5e-5; the gloo world equals
the stacked (2, 2) run bitwise (l∞).  The pass-count tests port
``tests/test_fused.py``'s, and (1, 1) must equal ``solve_single``
(``tests/test_solvers.py``'s contract).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import detection as jdet
from repro.launch.mesh import compat_make_mesh
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.convdiff import make_rhs
from repro.solvers.fixed_point import SolverConfig as JSolverConfig
from repro.solvers.fixed_point import make_sharded_solver as jmake_sharded_solver
from repro_torch import interop
from repro_torch.core import detection as tdet
from repro_torch.kernels.jacobi3d import ops as tops
from repro_torch.launch.mesh import spawn_world
from repro_torch.launch.worlds import Case, Inputs, make_inputs, run_cases
from repro_torch.solvers import fixed_point as tfp
from repro_torch.solvers.convdiff import Stencil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")
N = 8
RUNS = {f"{sweep}-{'fused' if fuse else 'unfused'}-{mode}": (sweep, fuse, mode)
        for sweep in ("jacobi", "hybrid") for fuse in (True, False)
        for mode in ("pfait", "nfais2")}


def _jax_config(name):
    sweep, fuse, mode = RUNS[name]
    st = JStencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    mon = jdet.for_mode(mode, eps_tilde=1e-7, margin=10.0, staleness=2, persistence=3,
                        ord=INF)
    return JSolverConfig(stencil=st, monitor=mon, inner_sweeps=2, max_outer=2000,
                         sweep=sweep, use_kernel=True, fuse_residual=fuse)


def _config(name):
    return interop.solver_config_from(_jax_config(name))


_PROGRAM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
    import test_torch_sharded_solver as t
    from repro.launch.mesh import compat_make_mesh
    from repro.solvers.convdiff import make_rhs
    from repro.solvers.fixed_point import make_sharded_solver

    mesh = compat_make_mesh((2, 2), ("data", "model"))
    b = jnp.asarray(make_rhs(t.N, seed=0))
    out = {}
    for name in t.RUNS:
        r = jax.jit(make_sharded_solver(t._jax_config(name), mesh))(jnp.zeros_like(b), b)
        for k, v in r._asdict().items():
            out[name + "/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("JAX_SHARDED_OK", len(t.RUNS))
""")


@pytest.fixture(scope="module")
def jax_2x2(tmp_path_factory):
    """JAX's (2, 2) runs, from one subprocess on 4 host devices."""
    path = tmp_path_factory.mktemp("jax_sharded") / "runs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROGRAM, str(path), REPO],
                         env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_SHARDED_OK" in out.stdout
    with np.load(path) as z:
        return {name: {k: z[f"{name}/{k}"] for k in ("x", "residual", "outer_iters",
                                                      "converged")} for name in RUNS}


@pytest.fixture(scope="module")
def gloo_2x2(tmp_path_factory):
    """The port's (2, 2) runs over a spawned gloo world of 4 ranks."""
    cases = [Case(name, "solver", _config(name), (2, 2), Inputs("convdiff", N))
             for name in RUNS]
    ranks = spawn_world(run_cases, 4, str(tmp_path_factory.mktemp("world")),
                        args=("gloo", cases, "cpu"), timeout=300)
    return {c["name"]: c for c in ranks[0]["cases"]}, ranks


def _hold(got_x, got_res, got_outer, got_conv, want):
    assert got_conv == bool(want["converged"]) is True
    assert got_outer == int(want["outer_iters"])
    assert got_res == pytest.approx(float(want["residual"]), rel=5e-5)
    np.testing.assert_allclose(got_x, np.asarray(want["x"]), atol=1e-10, rtol=0)


def test_inputs_are_the_jax_inputs():
    x0, b, kw = make_inputs(Inputs("convdiff", N))
    np.testing.assert_array_equal(b, make_rhs(N, seed=0))
    assert kw["stencil"] == _config(next(iter(RUNS))).stencil
    assert not x0.any()


@pytest.mark.parametrize("name", list(RUNS))
def test_single_block_matches_jax(name):
    b = make_rhs(N, seed=0)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    want = jax.jit(jmake_sharded_solver(_jax_config(name), mesh))(
        jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b))
    got = tfp.make_sharded_solver(_config(name), (1, 1), device="cpu")(np.zeros_like(b), b)
    _hold(got.x.numpy(), float(got.residual), got.outer_iters, got.converged,
          want._asdict())


@pytest.mark.parametrize("name", list(RUNS))
def test_stacked_2x2_matches_jax(jax_2x2, name):
    b = make_rhs(N, seed=0)
    got = tfp.make_sharded_solver(_config(name), (2, 2), device="cpu")(np.zeros_like(b), b)
    _hold(got.x.numpy(), float(got.residual), got.outer_iters, got.converged,
          jax_2x2[name])


@pytest.mark.parametrize("name", list(RUNS))
def test_gloo_2x2_matches_jax_and_stacked(jax_2x2, gloo_2x2, name):
    runs, ranks = gloo_2x2
    got = runs[name]
    _hold(got["x"], got["residual"], got["outer_iters"], got["converged"], jax_2x2[name])
    b = make_rhs(N, seed=0)
    stacked = tfp.make_sharded_solver(_config(name), (2, 2), device="cpu")(
        np.zeros_like(b), b)
    np.testing.assert_array_equal(got["x"], stacked.x.numpy())
    assert got["outer_iters"] == stacked.outer_iters
    assert got["residual"] == float(stacked.residual)
    for r in ranks[1:]:
        c = next(c for c in r["cases"] if c["name"] == name)
        assert (c["outer_iters"], c["residual"], c["x_digest"]) == \
            (got["outer_iters"], got["residual"], got["x_digest"])


def _pass_cfg(inner_sweeps, fuse, sweep="hybrid"):
    st = Stencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    mon = tdet.for_mode("pfait", eps_tilde=1e-8, margin=10.0, staleness=2, ord=INF)
    return tfp.SolverConfig(stencil=st, monitor=mon, inner_sweeps=inner_sweeps,
                            max_outer=500, sweep=sweep, use_kernel=True,
                            fuse_residual=fuse)


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
@pytest.mark.parametrize("inner_sweeps", [1, 3])
def test_sharded_solver_single_fused_pass_per_outer(mesh, inner_sweeps):
    """With fusion each outer iteration is one fused sweep+residual pass
    (the last inner sweep) and no residual-only pass, per block."""
    b = make_rhs(N, seed=0)
    tops.reset_pass_counts()
    r = tfp.make_sharded_solver(_pass_cfg(inner_sweeps, True), mesh, device="cpu")(
        np.zeros_like(b), b)
    counts = dict(tops.PASS_COUNTS)
    assert counts["residual"] == 0, counts
    assert counts["fused"] == r.outer_iters * int(np.prod(mesh)) > 0, counts
    assert counts["sweep"] == (inner_sweeps - 1) * counts["fused"], counts


@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
def test_sharded_solver_unfused_baseline_has_residual_pass(mesh):
    b = make_rhs(N, seed=0)
    tops.reset_pass_counts()
    tfp.make_sharded_solver(_pass_cfg(1, False), mesh, device="cpu")(np.zeros_like(b), b)
    counts = dict(tops.PASS_COUNTS)
    assert counts["fused"] == 0, counts
    assert counts["residual"] == counts["sweep"] > 0, counts


@pytest.mark.parametrize("sweep", ["hybrid", "jacobi"])
def test_sharded_solver_single_device_mesh_matches_single(sweep):
    st = Stencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = make_rhs(N, seed=0)
    mon = tdet.for_mode("pfait", eps_tilde=1e-8, margin=10.0, staleness=2, ord=INF)
    cfg = tfp.SolverConfig(stencil=st, monitor=mon, inner_sweeps=2, max_outer=20_000,
                           sweep=sweep)
    r_mesh = tfp.make_sharded_solver(cfg, (1, 1), device="cpu")(np.zeros_like(b), b)
    r_single = tfp.solve_single(cfg, b, device="cpu")
    assert r_mesh.converged
    np.testing.assert_allclose(r_mesh.x.numpy(), r_single.x.numpy(), atol=1e-12)
    assert r_mesh.outer_iters == r_single.outer_iters
    assert bool((r_mesh.x == r_single.x).all())   # the same operations, bitwise


def test_composite_axes_and_bad_splits():
    """A composite x axis ranks its blocks row-major in the order given; a
    split that leaves out or repeats a mesh axis is refused."""
    b = make_rhs(N, seed=0)
    cfg = _pass_cfg(2, True)
    one = tfp.make_sharded_solver(cfg, (4, 1), device="cpu")(np.zeros_like(b), b)
    comp = tfp.make_sharded_solver(cfg, (2, 2), ax_x=("shard_x", "shard_y"), ax_y=(),
                                   device="cpu")(np.zeros_like(b), b)
    assert comp.outer_iters == one.outer_iters
    assert bool((comp.x == one.x).all())
    with pytest.raises(ValueError, match="split the mesh"):
        tfp.make_sharded_solver(cfg, (2, 2), ax_x="shard_x", ax_y="shard_x", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tfp.make_sharded_solver(cfg, (3, 1), device="cpu")(np.zeros_like(b), b)
