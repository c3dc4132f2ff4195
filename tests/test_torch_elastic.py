"""The port's fault tolerance and elastic driver against the JAX package's
(``runtime/fault_tolerance.py``, ``runtime/elastic.py``).

* ``fault_tolerance``: heartbeats, straggler checks, ``health_from_sweeps``
  and ``plan_restart`` give JAX's verdicts on equal inputs.
* ``remesh`` / ``validate_specs`` / ``reshard`` on shape tuples,
  ``shrink_to_fit`` and ``FaultPlan`` validation as JAX's.
* ``run_elastic`` at one slot in process (uninterrupted, and a spare join)
  against JAX's on a 1-device mesh, and JAX's 4-device crash → shrink →
  regrow case (``tests/test_elastic_restart.py:269-302``, convdiff n = 24)
  plus a PageRank crash case against one JAX subprocess with 4 forced host
  devices.  The bar: equal ``events``, ``mesh_history``, ``restarts``,
  ``stall_segments``, ``lost_iters``, ``detect_latency``,
  ``members_final``, ``outer_iters``, ``segments_run``,
  ``checkpoint_saves`` and ``converged``; x within atol 1e-10.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.runtime import elastic as jel
from repro.runtime import fault_tolerance as jft
from repro.runtime.shard_runtime import ShardRuntimeConfig as JShardConfig
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.convdiff import make_rhs
from repro_torch import interop
from repro_torch.runtime import elastic as tel
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.solvers.pagerank import PageRankProblem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jax.sharding.PartitionSpec


# ---------------------------------------------------------------------------
# fault_tolerance against JAX's
# ---------------------------------------------------------------------------


def test_heartbeats_match_jax():
    jhb, thb = jft.HeartbeatMonitor(timeout=2.0), tft.HeartbeatMonitor(timeout=2.0)
    for hb in (jhb, thb):
        hb.beat(0, 10.0)
        hb.register([0, 1, 2], t=0.0)
        hb.beat(2, 3.0)
    for t in (1.0, 2.5, 5.5, 11.0, 13.0):
        assert thb.failed(t) == jhb.failed(t) and thb.alive(t) == jhb.alive(t)


def test_stragglers_match_jax():
    rng = np.random.default_rng(0)
    js = jft.StragglerPolicy(factor=2.0, persistence=3, window=8)
    ts = tft.StragglerPolicy(factor=2.0, persistence=3, window=8)
    for step in range(40):
        for w in range(5):
            d = float(rng.random()) * (3.0 if w == 3 and step > 10 else 1.0)
            js.record(w, d)
            ts.record(w, d)
        assert ts.check() == js.check()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_from_sweeps_matches_jax(seed):
    rng = np.random.default_rng(seed)
    t, sweeps = 0.0, []
    for _ in range(600):
        w = int(rng.integers(0, 6))
        if w == 2 and 100 < len(sweeps) < 250:
            continue   # worker 2 goes silent for a while
        t += float(rng.exponential(0.01 if w != 4 else 0.05))
        sweeps.append((t, w))
    for timeout in (0.05, 0.5, 5.0):
        want = jft.health_from_sweeps(sweeps, 6, timeout, check_every=32)
        got = tft.health_from_sweeps(sweeps, 6, timeout, check_every=32)
        assert (got.silent_workers, got.stragglers, got.max_silence) == \
            (want.silent_workers, want.stragglers, want.max_silence)
    assert tft.health_from_sweeps([], 3, 1.0) == tft.PlatformHealth((), (), 0.0)


@pytest.mark.parametrize("step,workers,failed,axis", [
    (10, range(8), [0, 1, 2, 3, 4], 16), (None, [0, 1, 2], [2], 1),
    (40, range(32), [5], 16), (7, range(6), [1], 1)])
def test_plan_restart_matches_jax(step, workers, failed, axis):
    want = jft.plan_restart(step, workers=workers, failed=failed, model_axis=axis)
    got = tft.plan_restart(step, workers=workers, failed=failed, model_axis=axis)
    assert (got.checkpoint_step, got.surviving_workers, got.new_mesh_shape,
            got.data_resume_step, got.world_size) == \
        (want.checkpoint_step, want.surviving_workers, want.new_mesh_shape,
         want.data_resume_step, want.world_size)


def test_plan_restart_zero_survivors_raises():
    with pytest.raises(RuntimeError, match="no survivors"):
        tft.plan_restart(checkpoint_step=5, workers=[0, 1], failed=[0, 1])


# ---------------------------------------------------------------------------
# Shard-count surgery, shrink_to_fit, FaultPlan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev,axis", [(1, 1), (4, 1), (8, 4), (3, 4), (16, 16)])
def test_remesh_shapes(n_dev, axis):
    data = max(n_dev // axis, 1)
    assert tel.remesh(n_dev, axis) == {"data": data, "model": axis if n_dev >= axis else n_dev}
    if n_dev == 1:
        assert tel.remesh(1, 1) == dict(jel.remesh(1, model_axis=1).shape)


def test_validate_specs_accepts_and_rejects_divisibility():
    one, two = tel.remesh(1, 1), {"data": 1, "model": 2}
    assert tel.validate_specs((8, 4), ("model", None), one)
    assert tel.validate_specs((7, 4), ("model", None), one)      # 7 % 1 == 0
    assert not tel.validate_specs((7, 4), ("model", None), two)
    assert tel.validate_specs((8, 4), ("model",), two)
    assert not tel.validate_specs({"a": (8, 4), "b": [(6,), (5, 3)]},
                                  {"a": ("model", None), "b": [("model",), (None, None)]},
                                  {"data": 1, "model": 3})
    assert tel.validate_specs((8, 6), (("data", "model"), None), {"data": 2, "model": 4})
    assert tel.validate_specs((5,), None, two)


def test_reshard_places_host_arrays():
    tree = {"w": np.arange(8.0).reshape(8, 1)}
    out = tel.reshard(tree, {"w": ("model", None)}, tel.remesh(1, 1), device="cpu")
    assert isinstance(out["w"], torch.Tensor)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])


@pytest.mark.parametrize("n,surv,red", [(24, 4, "nonblocking"), (24, 5, "nonblocking"),
                                        (24, 3, "nonblocking"), (24, 3, "rdoubling"),
                                        (24, 7, "rdoubling"), (150, 5, "nonblocking"),
                                        (16384, 3, "nonblocking"), (7, 9, "blocking")])
def test_shrink_to_fit_matches_jax(n, surv, red):
    assert tel.shrink_to_fit(n, surv, red) == jel.shrink_to_fit(n, surv, red)


def test_shrink_to_fit_refusals_match_jax():
    for args in ((24, 0), (24, 3, "gossip")):
        with pytest.raises(ValueError) as ej:
            jel.shrink_to_fit(*args)
        with pytest.raises(ValueError) as et:
            tel.shrink_to_fit(*args)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [dict(crash_at={-1: 3}), dict(crash_at={1: 5}, join_at={1: 2}),
                                dict(join_at={2: -1})])
def test_fault_plan_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ej:
        jel.FaultPlan(**kw)
    with pytest.raises(ValueError) as et:
        tel.FaultPlan(**kw)
    assert str(et.value) == str(ej.value)
    tel.FaultPlan(crash_at={1: 2}, join_at={1: 6})  # repair after crash: ok


# ---------------------------------------------------------------------------
# run_elastic at one slot, in process
# ---------------------------------------------------------------------------


def _jcfg(staleness=1, persistence=2, inner=1, delay=0, lag=1, ord=2.0, eps_tilde=1e-6):
    mon = jdet.for_mode("pfait", eps_tilde=eps_tilde, margin=10.0, staleness=staleness,
                        persistence=persistence, ord=ord)
    return JShardConfig(monitor=mon, reduction="nonblocking", inner_sweeps=inner,
                        halo_delay=delay, contrib_lag=lag)


def _convdiff(n):
    st = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    b = make_rhs(n, seed=0)
    return st, b


FIELDS = ("converged", "outer_iters", "segments_run", "restarts", "stall_segments",
          "lost_iters", "detect_latency", "checkpoint_saves", "mesh_history",
          "stragglers_flagged", "members_final", "events")


def _assert_same_report(got, want, atol=1e-10):
    """``want`` is JAX's ``ElasticReport`` (or a dict of its fields)."""
    w = want if isinstance(want, dict) else {f: getattr(want, f) for f in
                                             FIELDS + ("x", "detected_residual")}
    for f in FIELDS:
        g, v = getattr(got, f), w[f]
        if f in ("mesh_history", "events"):
            g, v = [tuple(e) for e in g], [tuple(e) for e in v]
        elif f == "members_final":
            g, v = tuple(g), tuple(v)
        assert g == v, (f, g, v)
    assert got.detected_residual == pytest.approx(w["detected_residual"], rel=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(w["x"]), atol=atol, rtol=0)


@pytest.mark.parametrize("plan", [{}, dict(join_at={1: 1})], ids=["uninterrupted", "spare"])
def test_run_elastic_one_slot_matches_jax(tmp_path, plan):
    n = 8
    st, b = _convdiff(n)
    jcfg = _jcfg()
    knobs = dict(segment_len=25, max_segments=40)
    want = jel.run_elastic("convdiff", jcfg, n, np.zeros_like(b), b, jel.FaultPlan(**plan),
                           str(tmp_path / "jax"), stencil=st, p0=1, **knobs)
    got = tel.run_elastic("convdiff", interop.shard_config_from(jcfg), n, np.zeros_like(b), b,
                          tel.FaultPlan(**plan), str(tmp_path / "port"),
                          stencil=interop.stencil_from(st), slots=1, device="cpu", **knobs)
    _assert_same_report(got, want)
    assert got.converged and got.restarts == 0 and got.stall_segments == 0
    assert got.mesh_history == [(0, 1)]
    assert len(got.segment_walls) == got.segments_run
    if plan:
        assert got.members_final == (0, 1)   # a spare of the control plane
        assert any(ev[1] == "join" for ev in got.events)


def test_run_elastic_refusals(tmp_path):
    mon = interop.monitor_from(jdet.for_mode("pfait", eps_tilde=1e-6, ord=2.0))
    cfg = interop.shard_config_from(JShardConfig(monitor=jdet.for_mode("pfait", eps_tilde=1e-6),
                                                 inner_sweeps=(1, 2, 1, 2)))
    with pytest.raises(ValueError, match="scalar inner_sweeps"):
        tel.run_elastic("convdiff", cfg, 8, np.zeros((8, 8, 8)), np.zeros((8, 8, 8)),
                        tel.FaultPlan(), str(tmp_path), slots=1, device="cpu")
    cfg = interop.shard_config_from(JShardConfig(monitor=jdet.for_mode("pfait",
                                                                       eps_tilde=1e-6)))
    assert cfg.monitor == mon
    with pytest.raises(ValueError, match="slots="):
        tel.run_elastic("convdiff", cfg, 8, np.zeros((8, 8, 8)), np.zeros((8, 8, 8)),
                        tel.FaultPlan(), str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="p0=3 unusable"):
        tel.run_elastic("convdiff", cfg, 8, np.zeros((8, 8, 8)), np.zeros((8, 8, 8)),
                        tel.FaultPlan(), str(tmp_path), slots=3, device="cpu")


# ---------------------------------------------------------------------------
# Crash → shrink → regrow against JAX on 4 forced host devices
# ---------------------------------------------------------------------------


def _cases():
    """The subprocess's cases: (family, jax config, n, knobs, plan kwargs)."""
    return {
        # tests/test_elastic_restart.py:269-302
        "convdiff": ("convdiff", _jcfg(staleness=2, persistence=4, inner=2, delay=1, lag=1),
                     24, dict(p0=4, segment_len=10, ckpt_every=2, max_segments=60),
                     dict(crash_at={1: 3}, join_at={1: 8})),
        "pagerank": ("pagerank", _jcfg(staleness=2, persistence=4, ord=1.0, eps_tilde=1e-9),
                     64, dict(p0=4, segment_len=5, ckpt_every=2, max_segments=80),
                     dict(crash_at={2: 2}, join_at={2: 6})),
    }


def _inputs(family, n):
    if family == "convdiff":
        st, b = _convdiff(n)
        return np.zeros_like(b), b, dict(stencil=st)
    prob = PageRankProblem(n=n, p=4, seed=0)
    return np.full(n, 1.0 / n), prob.to_dense(), dict(damping=prob.d)


_PROGRAM = textwrap.dedent("""
    import os, sys, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
    import test_torch_elastic as t
    from repro.runtime import elastic as el

    assert len(jax.devices()) == 4
    out = {}
    for name, (family, cfg, n, knobs, plan) in t._cases().items():
        x0, arg, kw = t._inputs(family, n)
        with tempfile.TemporaryDirectory() as d:
            rep = el.run_elastic(family, cfg, n, x0, arg, el.FaultPlan(**plan), d,
                                 **knobs, **kw)
        for f in t.FIELDS + ("x", "detected_residual"):
            v = getattr(rep, f)
            if f == "events":
                v = np.asarray([list(map(str, e)) for e in v])
            out[name + "/" + f] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("JAX_ELASTIC_RUNS_OK", len(out))
""")


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_elastic") / "runs.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROGRAM, str(path), REPO],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_ELASTIC_RUNS_OK" in out.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _from_npz(runs, name):
    w = {k.split("/", 1)[1]: v for k, v in runs.items() if k.startswith(name + "/")}
    w["events"] = [(int(s), kind, detail) for s, kind, detail in w["events"].tolist()]
    w["mesh_history"] = [tuple(map(int, e)) for e in w["mesh_history"].tolist()]
    w["members_final"] = tuple(int(m) for m in w["members_final"])
    w["detect_latency"] = [float(v) for v in w["detect_latency"]]
    w["stragglers_flagged"] = [int(v) for v in w["stragglers_flagged"]]
    for f in ("converged", "outer_iters", "segments_run", "restarts", "stall_segments",
              "lost_iters", "checkpoint_saves"):
        w[f] = w[f].item()
    w["detected_residual"] = float(w["detected_residual"])
    return w


@pytest.mark.parametrize("name", ["convdiff", "pagerank"])
def test_crash_shrink_regrow_matches_jax(jax_multi, tmp_path, name):
    family, jcfg, n, knobs, plan = _cases()[name]
    x0, arg, kw = _inputs(family, n)
    if family == "convdiff":
        kw = dict(stencil=interop.stencil_from(kw["stencil"]))
    knobs = {**knobs, "slots": knobs.pop("p0")}
    got = tel.run_elastic(family, interop.shard_config_from(jcfg), n, x0, arg,
                          tel.FaultPlan(**plan), str(tmp_path), device="cpu", **knobs, **kw)
    _assert_same_report(got, _from_npz(jax_multi, name))
    assert got.converged and got.restarts == 1 and got.stall_segments >= 1
    assert got.detect_latency and got.detect_latency[0] > 0
    ps = [p for _, p in got.mesh_history]
    assert ps[0] == 4 and ps[-1] == 4 and len(ps) == 3, ps   # shrink then regrow
    assert got.members_final == (0, 1, 2, 3)
    if family == "convdiff":
        assert 3 in ps and got.lost_iters > 0
    else:
        assert 2 in ps   # 3 survivors: 64 rows split in 2
