"""The port's PageRank problem and PageRank shard runtime against the JAX
package's.

* ``PageRankProblem``: the same seed draws the same graph, so ``to_dense()``
  is bitwise the JAX package's for several (n, p, seed, avg_deg, hub_skew);
  ``d``, ``v`` and ``exact_residual`` are equal.
* p = 1: the cases of JAX's ``test_pagerank_runtime_single_shard`` and
  ``test_pagerank_trace_matches_reference`` against the JAX runtime on a
  1-shard mesh: same ``outer_iters`` and ``converged``, finite trace entries
  within rtol 5e-5 (JAX's bar, ``tests/test_shard_runtime.py:259``), x
  within atol 1e-12; ``pagerank_reference_trace`` within rtol 5e-5 of
  JAX's.
* p = 2 and p = 4 (blocking, non-blocking with heterogeneous knobs,
  recursive doubling, NFAIS2): one JAX program in a subprocess with 4
  forced host devices runs the JAX runtime; the port on the stacked CPU
  transport must take the same outer iterations and verifications, with
  the same bars.
* Validation raises what the JAX runtime raises.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.launch.mesh import make_shard_mesh
from repro.runtime import shard_runtime as jsr
from repro.solvers.pagerank import PageRankProblem as JPageRank
from repro_torch import interop
from repro_torch.runtime import shard_runtime as tsr
from repro_torch.solvers.pagerank import PageRankProblem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MULTI = 64
HET = {2: dict(inner_sweeps=(1, 2), halo_delay=(0, 1), contrib_lag=(0, 1)),
       4: dict(inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2), contrib_lag=(0, 1, 0, 1))}


def _jmon(mode, eps_tilde=1e-9):
    if mode == "sync":
        return jdet.MonitorConfig(mode="sync", eps=eps_tilde, staleness=0, ord=1.0)
    return jdet.for_mode(mode, eps_tilde=eps_tilde, margin=10.0, staleness=2,
                         persistence=4, ord=1.0)


def _assert_same_run(got, want, atol=1e-12):
    """``want`` holds the JAX run's arrays (numpy)."""
    assert got.converged and bool(want["converged"])
    assert got.outer_iters == int(want["outer_iters"])
    assert got.verifications == int(want["verifications"])
    np.testing.assert_array_equal(got.local_sweeps, np.asarray(want["local_sweeps"]))
    trace, jtrace = got.trace.numpy(), np.asarray(want["trace"])
    fin = np.isfinite(jtrace)
    np.testing.assert_array_equal(np.isfinite(trace), fin)
    np.testing.assert_allclose(trace[fin], jtrace[fin], rtol=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want["x"]), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# The problem: the graph draw and the dense operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,seed,kw", [
    (64, 4, 0, {}),
    (64, 4, 1, {}),
    (256, 8, 3, dict(avg_deg=3.0, hub_skew=1.2)),
    (250, 5, 7, dict(avg_deg=1.0, damping=0.5)),
    (96, 2, 11, dict(avg_deg=40.0, hub_skew=0.0)),
    (8, 4, 2, dict(avg_deg=20.0)),   # deg capped at n - 1
])
def test_problem_matches_jax(n, p, seed, kw):
    want = JPageRank(n=n, p=p, seed=seed, **kw)
    got = PageRankProblem(n=n, p=p, seed=seed, **kw)
    Pw, Pg = want.to_dense(), got.to_dense()
    assert Pg.dtype == Pw.dtype and Pg.shape == Pw.shape
    assert Pg.tobytes() == Pw.tobytes()
    assert (got.n, got.p, got.block, got.d, got.v, got.ord) == \
        (want.n, want.p, want.block, want.d, want.v, want.ord)
    rng = np.random.default_rng(seed)
    xs = [rng.random(got.block) / n for _ in range(p)]
    assert got.exact_residual(xs) == want.exact_residual(xs)
    np.testing.assert_array_equal(got.assemble(xs), want.assemble(xs))


@pytest.mark.parametrize("ord", [1.0, 2.0, float("inf")])
def test_exact_residual_orders_match_jax(ord):
    want = JPageRank(n=64, p=4, seed=5, ord=ord)
    got = PageRankProblem(n=64, p=4, seed=5, ord=ord)
    xs = [np.full(16, 1.0 / 64) for _ in range(4)]
    assert got.exact_residual(xs) == want.exact_residual(xs)


@pytest.mark.parametrize("kw", [dict(n=10, p=4), dict(damping=1.0), dict(damping=0.0)])
def test_problem_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as ej:
        JPageRank(**kw)
    with pytest.raises(ValueError) as et:
        PageRankProblem(**kw)
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# p = 1 against the JAX runtime
# ---------------------------------------------------------------------------


def _single_shard(jcfg, n, seed):
    prob = PageRankProblem(n=n, p=4, seed=seed)
    P = prob.to_dense()
    x0 = np.full((n,), 1.0 / n)
    want = jax.jit(jsr.make_pagerank_runtime(jcfg, make_shard_mesh(1), n, prob.d))(
        jnp.asarray(x0), jnp.asarray(P))
    got = tsr.make_pagerank_runtime(interop.shard_config_from(jcfg), 1, n, prob.d,
                                    device="cpu")(x0, P)
    return prob, P, got, {k: np.asarray(v) for k, v in want._asdict().items()}


def test_pagerank_runtime_single_shard_matches_jax():
    """JAX's ``test_pagerank_runtime_single_shard`` case."""
    n = 64
    jcfg = jsr.ShardRuntimeConfig(
        monitor=jdet.MonitorConfig(mode="pfait", eps=1e-9, staleness=0, ord=1.0),
        reduction="nonblocking", max_outer=500, trace_len=64)
    prob, P, got, want = _single_shard(jcfg, n, seed=0)
    _assert_same_run(got, want)
    assert float(got.residual) == pytest.approx(float(want["residual"]), rel=1e-5)
    xs = got.x.numpy()
    assert float(np.sum(np.abs(prob.d * (P @ xs) + prob.v - xs))) < 1e-8


def test_pagerank_trace_matches_reference_and_jax():
    """JAX's ``test_pagerank_trace_matches_reference`` case: the blocking
    runtime follows the synchronous trajectory, the port's and JAX's."""
    n = 64
    jcfg = jsr.ShardRuntimeConfig(
        monitor=jdet.MonitorConfig(mode="sync", eps=1e-10, staleness=0, ord=1.0),
        reduction="blocking", max_outer=300, trace_len=128)
    prob, P, got, want = _single_shard(jcfg, n, seed=1)
    _assert_same_run(got, want)
    T = min(got.outer_iters, 128)
    ref = tsr.pagerank_reference_trace(torch.from_numpy(P), n, T, damping=prob.d, ord=1.0)
    assert ref.dtype == torch.float32 and ref.shape == (T,)
    np.testing.assert_allclose(got.trace.numpy()[:T], ref.numpy(), rtol=5e-5)


@pytest.mark.parametrize("ord", [1.0, 2.0, float("inf")])
@pytest.mark.parametrize("damping", [0.85, 0.5])
def test_reference_trace_matches_jax(ord, damping):
    n = 64
    P = PageRankProblem(n=n, p=4, seed=2, damping=damping).to_dense()
    want = np.asarray(jsr.pagerank_reference_trace(jnp.asarray(P), n, 40,
                                                   damping=damping, ord=ord))
    got = tsr.pagerank_reference_trace(torch.from_numpy(P), n, 40, damping=damping,
                                       ord=ord).numpy()
    # below 1e-10 the residual nears the f64 rounding of d·P x + v − x
    # (terms ≈ 1/n), where two summation orders part by more than the bar
    above = want > 1e-10
    assert above[:10].all()
    np.testing.assert_allclose(got[above], want[above], rtol=5e-5)


def test_family_dispatch():
    n = 16
    cfg = tsr.ShardRuntimeConfig(monitor=interop.monitor_from(_jmon("pfait")), max_outer=50)
    P = PageRankProblem(n=n, p=2, seed=0).to_dense()
    x0 = np.full(n, 1.0 / n)
    a = tsr.make_runtime("pagerank", cfg, 2, n, device="cpu")(x0, P)
    b = tsr.make_pagerank_runtime(cfg, 2, n, device="cpu")(x0, P)
    assert a.outer_iters == b.outer_iters and torch.equal(a.x, b.x)
    assert tsr.FAMILIES == jsr.FAMILIES
    with pytest.raises(KeyError, match="family"):
        tsr.make_runtime("heat", cfg, 2, n, device="cpu")
    with pytest.raises(ValueError, match="stencil="):
        tsr.make_runtime("convdiff", cfg, 2, n, device="cpu")


# ---------------------------------------------------------------------------
# Validation: what the JAX runtime refuses, with its messages
# ---------------------------------------------------------------------------


def _raises_same(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    return str(ej.value), str(et.value)


def test_refuses_overlap_like_jax():
    mon = _jmon("pfait")
    jcfg = jsr.ShardRuntimeConfig(monitor=mon, overlap=True)
    tcfg = interop.shard_config_from(jcfg)
    want, got = _raises_same(
        lambda: jsr.make_pagerank_runtime(jcfg, make_shard_mesh(1), 8),
        lambda: tsr.make_pagerank_runtime(tcfg, 1, 8, device="cpu"))
    assert got == want


def test_refuses_multi_axis_mesh_like_jax():
    jcfg = jsr.ShardRuntimeConfig(monitor=_jmon("pfait"))
    tcfg = interop.shard_config_from(jcfg)
    want, got = _raises_same(
        lambda: jsr.make_pagerank_runtime(jcfg, make_shard_mesh((1, 1)), 8),
        lambda: tsr.make_pagerank_runtime(tcfg, (1, 1), 8, device="cpu"))
    for part in ("pagerank shards are 1-D row blocks; got mesh", "multi-axis meshes are "
                 "convdiff-only"):
        assert part in want and part in got
    with pytest.raises(ValueError, match="multi-axis meshes are convdiff-only"):
        tsr.make_pagerank_runtime(
            tsr.ShardRuntimeConfig(monitor=tcfg.monitor, mesh_shape=(2, 2)), 4, 8,
            device="cpu")


def test_refuses_bad_shapes_and_knobs():
    tcfg = interop.shard_config_from(jsr.ShardRuntimeConfig(monitor=_jmon("pfait")))
    run = tsr.make_pagerank_runtime(tcfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match=r"x0 must be \(8,\)"):
        run(np.zeros(8), np.zeros((8, 4)))
    blocking = tsr.ShardRuntimeConfig(monitor=tcfg.monitor, reduction="blocking",
                                      halo_delay=1)
    with pytest.raises(ValueError, match="blocking"):
        tsr.make_pagerank_runtime(blocking, 2, 8, device="cpu")
    rd = tsr.ShardRuntimeConfig(monitor=tcfg.monitor, reduction="rdoubling")
    with pytest.raises(ValueError, match="power-of-two"):
        tsr.make_pagerank_runtime(rd, 3, 9, device="cpu")
    l3 = tsr.ShardRuntimeConfig(monitor=interop.monitor_from(
        jdet.MonitorConfig(mode="pfait", ord=3.0)))
    with pytest.raises(ValueError, match="ord 1, 2 or inf"):
        tsr.make_pagerank_runtime(l3, 2, 8, device="cpu")


# ---------------------------------------------------------------------------
# p = 2 and p = 4 against the JAX runtime on forced host devices
# ---------------------------------------------------------------------------

RUNS = {
    f"p{p}-{name}": dict(p=p, reduction=red, mode=mode, seed=seed, knobs=knobs)
    for p in (2, 4)
    for name, red, mode, seed, knobs in (
        ("blocking", "blocking", "sync", 1, {}),
        ("nonblocking-hetero", "nonblocking", "pfait", 0, HET[p]),
        ("rdoubling", "rdoubling", "pfait", 3, HET[p]),
        ("nfais2", "nonblocking", "nfais2", 4, HET[p]),
    )
}


def _jax_config(run):
    """The JAX config of a run (the subprocess builds the same one)."""
    return jsr.ShardRuntimeConfig(monitor=_jmon(run["mode"]), reduction=run["reduction"],
                                  max_outer=500, trace_len=64, **run["knobs"])


_PROGRAM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.join(sys.argv[3], "tests"))
    import test_torch_pagerank as t
    from repro.launch.mesh import make_shard_mesh
    from repro.runtime import shard_runtime as sr
    from repro.solvers.pagerank import PageRankProblem

    n = int(sys.argv[2])
    out = {}
    for name, run in t.RUNS.items():
        prob = PageRankProblem(n=n, p=4, seed=run["seed"])
        r = jax.jit(sr.make_pagerank_runtime(t._jax_config(run), make_shard_mesh(run["p"]),
                                             n, prob.d))(
            jnp.full((n,), 1.0 / n), jnp.asarray(prob.to_dense()))
        for k, v in r._asdict().items():
            out[name + "/" + k] = np.asarray(v)
    try:   # n % p: a refusal a 1-device mesh cannot show
        sr.make_pagerank_runtime(t._jax_config(t.RUNS["p4-blocking"]), make_shard_mesh(4),
                                 10)
    except ValueError as e:
        out["error/indivisible"] = np.asarray(str(e))
    np.savez(sys.argv[1], **out)
    print("JAX_PAGERANK_RUNS_OK", len(t.RUNS))
""")


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    """The JAX runs of ``RUNS``, from one subprocess on 4 host devices."""
    path = tmp_path_factory.mktemp("jax_pagerank") / "runs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROGRAM, str(path), str(N_MULTI), REPO],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_PAGERANK_RUNS_OK" in out.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(RUNS))
def test_multi_shard_matches_jax(jax_multi, name):
    run = RUNS[name]
    n = N_MULTI
    prob = PageRankProblem(n=n, p=4, seed=run["seed"])
    got = tsr.make_pagerank_runtime(interop.shard_config_from(_jax_config(run)), run["p"],
                                    n, prob.d, device="cpu")(np.full(n, 1.0 / n),
                                                             prob.to_dense())
    want = {k.split("/", 1)[1]: v for k, v in jax_multi.items()
            if k.startswith(name + "/")}
    _assert_same_run(got, want)
    # no false detection: the exact l1 residual of the result under ε̃
    assert prob.exact_residual([got.x.numpy()]) < 1e-9


def test_refuses_indivisible_n_like_jax(jax_multi):
    tcfg = interop.shard_config_from(_jax_config(RUNS["p4-blocking"]))
    with pytest.raises(ValueError) as et:
        tsr.make_pagerank_runtime(tcfg, 4, 10, device="cpu")
    assert str(et.value) == str(jax_multi["error/indivisible"])
