"""The port's asynchronous data-parallel training runtime against the JAX
package's (``runtime/train_async.py``).

* Host pieces: ``TrainAsyncConfig`` validation and ``effective_monitor``
  raise and return what JAX's do; ``safe_gamma`` (torch ``svdvals`` on the
  CPU) within rtol 1e-10 of JAX's (numpy ``svd``); ``reference_trace`` and
  ``exact_train_residual`` bitwise JAX's (the same numpy code).
* The runtime, {blocking, nonblocking, rdoubling} × {pfait, nfais2} ×
  {lstsq, logistic} × ``num_batches`` ∈ {1, 2}: at p = 1 against JAX's
  ``make_train_runtime`` on a 1-device mesh in process, and at p = 4
  (heterogeneous ``inner_steps`` / ``view_delay`` / ``contrib_lag`` off the
  blocking mode) against one JAX subprocess with 4 forced host devices.
  The bar: equal rounds, verifications, ``converged`` and ``local_steps``;
  X within atol 1e-12; the trace's finite entries within rtol 5e-5 (f32
  sums in another order), and bitwise in l∞ (the runs at
  ``num_batches=2``); the loss within rtol 1e-12.
* A gloo world of 4 ranks on the CPU (one replica per rank, each reading
  its own rows) against its stacked twin: X and the l∞ trace bitwise.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.core import detection as jdet
from repro.launch.mesh import make_shard_mesh
from repro.runtime import train_async as jta
from repro.solvers.mlfixed import MLFixedPointProblem
from repro_torch import interop
from repro_torch.runtime import api as tapi
from repro_torch.runtime import train_async as tta
from repro_torch.solvers.mlfixed import MLFixedPointProblem as TProblem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")
HET = dict(inner_steps=(2, 4, 2, 4), view_delay=(0, 1, 2, 1), contrib_lag=(0, 1, 0, 2))


def _problem(task="lstsq", seed=3, p=4):
    return MLFixedPointProblem(n=16, p=p, m_rows=64, task=task, seed=seed)


def _jcfg(run, p, gamma):
    """The JAX config of a grid run (the subprocess builds the same one)."""
    mon = jdet.for_mode(run["mode"], eps_tilde=1e-6, margin=10.0, staleness=2,
                        persistence=3, ord=run["ord"])
    knobs = HET if p == 4 and run["reduction"] != "blocking" else dict(inner_steps=2)
    return jta.TrainAsyncConfig(monitor=mon, reduction=run["reduction"],
                                num_batches=run["nb"], gamma=gamma, max_rounds=5000,
                                trace_len=64, **knobs)


def _tcfg(jcfg) -> tta.TrainAsyncConfig:
    def per_shard(v):
        return int(v) if np.isscalar(v) else tuple(int(e) for e in v)

    return tta.TrainAsyncConfig(
        monitor=interop.monitor_from(jcfg.monitor), reduction=jcfg.reduction,
        inner_steps=per_shard(jcfg.inner_steps), view_delay=per_shard(jcfg.view_delay),
        contrib_lag=per_shard(jcfg.contrib_lag), num_batches=jcfg.num_batches,
        gamma=jcfg.gamma, max_rounds=jcfg.max_rounds, trace_len=jcfg.trace_len)


RUNS = {
    f"{red}-{mode}-{task}-nb{nb}": dict(reduction=red, mode=mode, task=task, nb=nb,
                                        ord=2.0 if nb == 1 else INF)
    for red in ("blocking", "nonblocking", "rdoubling")
    for mode in ("pfait", "nfais2")
    for task in ("lstsq", "logistic")
    for nb in (1, 2)
}


def _assert_same_run(got, want, ord_):
    """``want`` holds the JAX run's arrays (numpy)."""
    assert got.converged and bool(want["converged"])
    assert got.rounds == int(want["rounds"])
    assert got.verifications == int(want["verifications"])
    np.testing.assert_array_equal(got.local_steps, np.asarray(want["local_steps"]))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want["x"]), atol=1e-12, rtol=0)
    trace, jtrace = got.trace.numpy(), np.asarray(want["trace"])
    fin = np.isfinite(jtrace)
    np.testing.assert_array_equal(np.isfinite(trace), fin)
    if np.isinf(ord_):
        np.testing.assert_array_equal(trace[fin], jtrace[fin])
    else:
        np.testing.assert_allclose(trace[fin], jtrace[fin], rtol=5e-5)
    np.testing.assert_allclose(float(got.loss), float(want["loss"]), rtol=1e-12)


# ---------------------------------------------------------------------------
# Host pieces
# ---------------------------------------------------------------------------


def test_effective_monitor_forces_k0_for_blocking_modes():
    mon = jdet.for_mode("pfait", eps_tilde=1e-6, staleness=3)
    for red in ("blocking", "nonblocking", "rdoubling"):
        want = jta.TrainAsyncConfig(monitor=mon, reduction=red).effective_monitor()
        got = tta.TrainAsyncConfig(monitor=interop.monitor_from(mon),
                                   reduction=red).effective_monitor()
        assert got == interop.monitor_from(want)
        assert got.staleness == (3 if red == "nonblocking" else 0)


@pytest.mark.parametrize("kw", [dict(reduction="gossip"), dict(num_batches=0)])
def test_config_validation_matches_jax(kw):
    mon = jdet.for_mode("pfait", eps_tilde=1e-6)
    with pytest.raises(ValueError) as ej:
        jta.TrainAsyncConfig(monitor=mon, **kw)
    with pytest.raises(ValueError) as et:
        tta.TrainAsyncConfig(monitor=interop.monitor_from(mon), **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("p,nb", [(3, 1), (4, 5)])
def test_safe_gamma_refuses_what_jax_refuses(p, nb):
    prob = _problem()
    with pytest.raises(ValueError) as ej:
        jta.safe_gamma(prob, p, num_batches=nb)
    with pytest.raises(ValueError) as et:
        tta.safe_gamma(prob, p, num_batches=nb, device="cpu")
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("task", ["lstsq", "logistic"])
@pytest.mark.parametrize("p,nb", [(1, 1), (1, 2), (4, 1), (4, 2), (2, 4)])
def test_safe_gamma_matches_jax(task, p, nb):
    prob = _problem(task)
    want = jta.safe_gamma(prob, p, num_batches=nb)
    got = tta.safe_gamma(prob, p, num_batches=nb, device="cpu")
    assert got == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("task", ["lstsq", "logistic"])
@pytest.mark.parametrize("ord", [2.0, 1.0, INF])
def test_oracles_bitwise_jax(task, ord):
    prob = _problem(task)
    gamma = jta.safe_gamma(prob, 4, num_batches=2)
    inner = [1, 2, 1, 3]
    Xw, refw = jta.reference_trace(prob, 4, inner, 2, gamma, rounds=40, ord=ord)
    Xg, refg = tta.reference_trace(prob, 4, inner, 2, gamma, rounds=40, ord=ord)
    assert Xg.tobytes() == Xw.tobytes() and refg.tobytes() == refw.tobytes()
    for phase in (0, 3):
        assert tta.exact_train_residual(prob, Xg, inner, gamma, ord=ord, num_batches=2,
                                        phase=phase) == \
            jta.exact_train_residual(prob, Xw, inner, gamma, ord=ord, num_batches=2,
                                     phase=phase)
    assert tta.init_replicas(prob, 4).tobytes() == jta.init_replicas(prob, 4).tobytes()


@pytest.mark.parametrize("task", ["lstsq", "logistic"])
def test_objective_matches_jax(task):
    prob = _problem(task)
    port = TProblem(n=16, p=4, m_rows=64, task=task, seed=3)
    x = np.linspace(-1, 1, 16)
    assert port.objective(x) == prob.objective(x)


# ---------------------------------------------------------------------------
# The runtime at p = 1, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_single_replica_matches_jax(name):
    run = RUNS[name]
    prob = _problem(run["task"], p=1)
    gamma = jta.safe_gamma(prob, 1, num_batches=run["nb"])
    jcfg = _jcfg(run, 1, gamma)
    want = jax.jit(jta.make_train_runtime(prob, jcfg, make_shard_mesh(1)))(
        jta.init_replicas(prob, 1), prob.A, prob.y)
    got = tta.make_train_runtime(prob, _tcfg(jcfg), 1, device="cpu")(
        tta.init_replicas(prob, 1), prob.A, prob.y)
    _assert_same_run(got, {k: np.asarray(v) for k, v in want._asdict().items()}, run["ord"])


def test_runtime_refuses_what_jax_refuses():
    prob = _problem()
    mon = jdet.for_mode("pfait", eps_tilde=1e-6)
    cases = [dict(inner_steps=0), dict(reduction="blocking", view_delay=1),
             dict(inner_steps=(1, 2))]
    for kw in cases:
        jcfg = jta.TrainAsyncConfig(monitor=mon, gamma=0.1, **kw)
        with pytest.raises(ValueError) as ej:
            jta.make_train_runtime(prob, jcfg, make_shard_mesh(1))
        with pytest.raises(ValueError) as et:
            tta.make_train_runtime(prob, _tcfg(jcfg), 1, device="cpu")
        assert str(et.value) == str(ej.value), kw
    with pytest.raises(ValueError, match="not divisible by num_batches"):
        tta.make_train_runtime(prob, tta.TrainAsyncConfig(
            monitor=interop.monitor_from(mon), num_batches=5, gamma=0.1), 4, device="cpu")
    with pytest.raises(ValueError, match="power-of-two"):
        tta.make_train_runtime(MLFixedPointProblem(n=16, m_rows=48), tta.TrainAsyncConfig(
            monitor=interop.monitor_from(mon), reduction="rdoubling", gamma=0.1), 3,
            device="cpu")


# ---------------------------------------------------------------------------
# p = 4 against the JAX runtime on forced host devices
# ---------------------------------------------------------------------------


_PROGRAM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
    import test_torch_train_async as t
    from repro.launch.mesh import make_shard_mesh
    from repro.runtime import train_async as ta

    mesh = make_shard_mesh(4)
    out = {}
    for name, run in t.RUNS.items():
        prob = t._problem(run["task"])
        gamma = ta.safe_gamma(prob, 4, num_batches=run["nb"])
        r = jax.jit(ta.make_train_runtime(prob, t._jcfg(run, 4, gamma), mesh))(
            ta.init_replicas(prob, 4), prob.A, prob.y)
        out[name + "/gamma"] = np.asarray(gamma)
        for k, v in r._asdict().items():
            out[name + "/" + k] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("JAX_TRAIN_RUNS_OK", len(t.RUNS))
""")


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    """The JAX runs of ``RUNS`` at p = 4, from one subprocess."""
    path = tmp_path_factory.mktemp("jax_train") / "runs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROGRAM, str(path), REPO],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_TRAIN_RUNS_OK" in out.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(RUNS))
def test_four_replicas_match_jax(jax_multi, name):
    run = RUNS[name]
    prob = _problem(run["task"])
    want = {k.split("/", 1)[1]: v for k, v in jax_multi.items()
            if k.startswith(name + "/")}
    gamma = float(want["gamma"])
    assert tta.safe_gamma(prob, 4, run["nb"], device="cpu") == pytest.approx(gamma, rel=1e-10)
    got = tta.make_train_runtime(prob, _tcfg(_jcfg(run, 4, gamma)), 4, device="cpu")(
        tta.init_replicas(prob, 4), prob.A, prob.y)
    _assert_same_run(got, want, run["ord"])
    # no false detection: the exact lifted residual of the result under ε̃
    cfg = _jcfg(run, 4, gamma)
    assert tta.exact_train_residual(prob, got.x.numpy(), cfg.inner_steps, gamma,
                                    ord=run["ord"], num_batches=run["nb"]) < 1e-6 * 10


# ---------------------------------------------------------------------------
# One replica per rank: a gloo world of 4 against its stacked twin
# ---------------------------------------------------------------------------


def test_gloo_world_matches_stacked_twin(tmp_path):
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.worlds import Case, run_cases, save_train_inputs

    prob = _problem("logistic")
    gamma = jta.safe_gamma(prob, 4, num_batches=2)
    mon = interop.monitor_from(jdet.for_mode("pfait", eps_tilde=1e-6, staleness=2,
                                             ord=INF))
    cfgs = {
        "nonblocking hetero": tapi.RuntimeConfig(
            monitor=mon, reduction="nonblocking", inner_sweeps=(2, 4, 2, 4),
            halo_delay=(0, 1, 2, 1), contrib_lag=(0, 1, 0, 1), num_batches=2,
            gamma=gamma, max_outer=5000, record_trace=True),
        "rdoubling": tapi.RuntimeConfig(monitor=mon, reduction="rdoubling", inner_sweeps=2,
                                        num_batches=2, gamma=gamma, max_outer=5000,
                                        trace_len=64),
    }
    data = save_train_inputs(prob, str(tmp_path / "logistic"))
    cases = [Case(name, "train", cfg, (4,), data) for name, cfg in cfgs.items()]
    ranks = spawn_world(run_cases, 4, str(tmp_path), args=("gloo", cases, "cpu"),
                        timeout=300)
    for i, (name, cfg) in enumerate(cfgs.items()):
        twin = tapi.run_train(prob, cfg, 4, tta.init_replicas(prob, 4), prob.A, prob.y,
                              device="cpu").raw
        got = [r["cases"][i] for r in ranks]
        assert all(g["x_digest"] == got[0]["x_digest"] for g in got)
        g = got[0]
        assert g["converged"] and twin.converged
        assert g["outer_iters"] == twin.rounds
        assert g["residual"] == float(twin.residual)
        np.testing.assert_array_equal(g["x"], twin.x.numpy())
        np.testing.assert_array_equal(g["trace"], twin.trace.numpy())
