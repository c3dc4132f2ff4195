"""The port's unified shard API, oracle scoring and schema traces against
the JAX package's.

* ``runtime/api.py``: JAX's ``tests/test_runtime_api.py`` shard cases —
  validation, the field mapping (every JAX ``RuntimeConfig`` field maps
  across), ``record_trace`` raising ``trace_len``, an unknown family,
  ``run_shard`` bitwise equal to ``make_runtime`` for both families, the
  ``rerun`` segments — and ``run_shard`` against JAX's ``run_shard`` (same
  iterations and detection step, residual history within rtol 5e-5).
* ``core/termination.py``, ``core/residual.global_residual`` and the
  reduction registry's topology facts equal JAX's on the same inputs
  (``global_residual`` within rtol 1e-6: f32 sums in another order).
* ``run_train`` / ``run_elastic`` and ``to_train_config``: JAX's
  ``tests/test_runtime_api.py:117-158`` and ``:204-211`` cases against
  JAX's entry points (rounds, detection, x within atol 1e-12 / 1e-10,
  membership log), ``to_train_config`` field for field;
  ``trace_from_train_run`` / ``trace_from_elastic_report`` write JAX's text
  on one result, and a port train trace loads in JAX's ``Trace.loads`` and
  ``replay``.
* ``core/trace.py``: the schema cases of JAX's ``tests/test_trace.py``; a
  port trace's ``dumps()`` loads into JAX's ``Trace.loads``, validates and
  has JAX's fingerprint; ``trace_from_shard_run`` writes the same text as
  JAX's adapter on the same run (1-D and mesh runs); a port run's trace
  has the events of JAX's trace of the same run in kind, worker and step,
  with residuals within rtol 5e-5; JAX's ``sim/replay.replay`` and
  ``sim/calibrate.fit_cost_model`` accept it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.core import reduction as jred
from repro.core import residual as jres
from repro.core import termination as jterm
from repro.core import trace as jtrace
from repro.launch.mesh import make_shard_mesh
from repro.runtime import api as japi
from repro.sim.calibrate import fit_cost_model
from repro.sim.replay import WhatIf, replay
from repro.solvers.convdiff import Stencil as JStencil
from repro.solvers.convdiff import make_rhs
from repro_torch import interop
from repro_torch.core import reduction as tred
from repro_torch.core import residual as tres
from repro_torch.core import termination as tterm
from repro_torch.core import trace as ttrace
from repro_torch.runtime import api as tapi
from repro_torch.runtime import shard_runtime as tsr
from repro_torch.solvers.pagerank import PageRankProblem

INF = float("inf")


def _jmon(mode="pfait", eps_tilde=1e-6, staleness=2, ord=2.0):
    return jdet.for_mode(mode, eps_tilde=eps_tilde, staleness=staleness, ord=ord)


def _tcfg(jcfg) -> tapi.RuntimeConfig:
    """A JAX ``RuntimeConfig`` carried across field by field (the monitor
    through ``interop``)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["monitor"] = interop.monitor_from(jcfg.monitor)
    return tapi.RuntimeConfig(**fields)


def _convdiff(n=8, rho=0.9, seed=0):
    st = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=rho)
    b = make_rhs(n, seed=seed)
    return st, interop.stencil_from(st), b, np.zeros_like(b)


def _pagerank(n=64, seed=0):
    prob = PageRankProblem(n=n, p=4, seed=seed)
    return prob, prob.to_dense(), np.full(n, 1.0 / n)


def _run(family, jcfg, p=1, **kw):
    """The port's ``run_shard`` on the CPU for a family's small case."""
    if family == "convdiff":
        _, st, b, x0 = _convdiff()
        return tapi.run_shard("convdiff", _tcfg(jcfg), p, 8, x0, b, stencil=st,
                              device="cpu", **kw)
    prob, P, x0 = _pagerank()
    return tapi.run_shard("pagerank", _tcfg(jcfg), p, prob.n, x0, P, damping=prob.d,
                          device="cpu", **kw)


def _family_mon(family):
    return _jmon() if family == "convdiff" else _jmon(eps_tilde=1e-9, ord=1.0)


# ---------------------------------------------------------------------------
# RuntimeConfig validation + conversion
# ---------------------------------------------------------------------------


def test_config_validates_reduction_at_construction():
    with pytest.raises(ValueError, match="reduction") as ej:
        japi.RuntimeConfig(monitor=_jmon(), reduction="gossip")
    with pytest.raises(ValueError, match="reduction") as et:
        tapi.RuntimeConfig(monitor=interop.monitor_from(_jmon()), reduction="gossip")
    assert str(et.value) == str(ej.value)


def test_config_validates_max_outer():
    with pytest.raises(ValueError, match="max_outer") as ej:
        japi.RuntimeConfig(monitor=_jmon(), max_outer=0)
    with pytest.raises(ValueError, match="max_outer") as et:
        tapi.RuntimeConfig(monitor=interop.monitor_from(_jmon()), max_outer=0)
    assert str(et.value) == str(ej.value)


def test_config_has_every_jax_field():
    names = [f.name for f in dataclasses.fields(japi.RuntimeConfig)]
    assert [f.name for f in dataclasses.fields(tapi.RuntimeConfig)] == names
    jcfg = japi.RuntimeConfig(monitor=_jmon())
    tcfg = tapi.RuntimeConfig(monitor=interop.monitor_from(_jmon()))
    for name in names:
        if name != "monitor":
            assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tapi.DEFAULT_TRACE_LEN == japi.DEFAULT_TRACE_LEN


@pytest.mark.parametrize("kw", [
    dict(reduction="blocking", inner_sweeps=3, halo_delay=1, contrib_lag=2,
         max_outer=123, trace_len=7, sweep="jacobi"),
    dict(reduction="nonblocking", inner_sweeps=(1, 2), halo_delay=(0, 1),
         contrib_lag=(1, 0), sweep="hybrid", mesh_shape=(2, 1), overlap=False,
         num_batches=3, gamma=0.5, axis="x"),
    dict(reduction="rdoubling", overlap=True, record_trace=True, max_outer=100),
])
def test_to_shard_config_field_mapping(kw):
    jcfg = japi.RuntimeConfig(monitor=_jmon(), **kw)
    scfg = _tcfg(jcfg).to_shard_config()
    assert scfg == interop.shard_config_from(jcfg.to_shard_config())
    assert scfg.effective_monitor() == interop.monitor_from(
        jcfg.to_shard_config().effective_monitor())


def test_blocking_mapping_forces_zero_staleness():
    cfg = tapi.RuntimeConfig(monitor=interop.monitor_from(_jmon()), reduction="blocking",
                             inner_sweeps=3, halo_delay=1, contrib_lag=2,
                             max_outer=123, trace_len=7, sweep="jacobi")
    scfg = cfg.to_shard_config()
    assert scfg.reduction == "blocking"
    assert scfg.inner_sweeps == 3 and scfg.halo_delay == 1
    assert scfg.contrib_lag == 2 and scfg.max_outer == 123
    assert scfg.trace_len == 7
    assert scfg.effective_monitor().staleness == 0


def test_record_trace_raises_trace_len():
    mon = interop.monitor_from(_jmon())
    cfg = tapi.RuntimeConfig(monitor=mon, record_trace=True, max_outer=5000)
    assert cfg.to_shard_config().trace_len == tapi.DEFAULT_TRACE_LEN
    small = tapi.RuntimeConfig(monitor=mon, record_trace=True, max_outer=100)
    assert small.to_shard_config().trace_len == 100
    pinned = tapi.RuntimeConfig(monitor=mon, record_trace=True, trace_len=64)
    assert pinned.to_shard_config().trace_len == 64


def test_unknown_family_raises_keyerror():
    cfg = tapi.RuntimeConfig(monitor=interop.monitor_from(_jmon()))
    with pytest.raises(KeyError, match="family"):
        tapi.run_shard("heat", cfg, 1, 8, np.zeros((8, 8, 8)), np.zeros((8, 8, 8)),
                       device="cpu")


# ---------------------------------------------------------------------------
# run_shard: bitwise the runtime it builds, and JAX's run_shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["convdiff", "pagerank"])
@pytest.mark.parametrize("p", [1, 2])
def test_run_shard_matches_make_runtime_bitwise(family, p):
    jcfg = japi.RuntimeConfig(monitor=_family_mon(family), reduction="nonblocking",
                              max_outer=500, trace_len=512)
    rep = _run(family, jcfg, p)
    if family == "convdiff":
        _, st, b, x0 = _convdiff()
        legacy = tsr.make_runtime("convdiff", _tcfg(jcfg).to_shard_config(), p, 8,
                                  stencil=st, device="cpu")(x0, b)
    else:
        prob, P, x0 = _pagerank()
        legacy = tsr.make_runtime("pagerank", _tcfg(jcfg).to_shard_config(), p, prob.n,
                                  damping=prob.d, device="cpu")(x0, P)
    assert isinstance(rep, tapi.RunReport)
    assert rep.converged == legacy.converged is True
    assert rep.outer_iters == legacy.outer_iters
    assert torch.equal(rep.x, legacy.x)
    assert torch.equal(rep.raw.trace, legacy.trace)
    assert rep.detected_residual == float(legacy.residual)
    assert rep.detect_step == rep.outer_iters - 1
    assert [nm for nm, _ in rep.wall_segments] == ["build", "run"]
    assert rep.wall_s > 0
    assert rep.trace.meta["outer_iters"] == rep.outer_iters   # trace_len > 0 records
    assert rep.membership_log == []


@pytest.mark.parametrize("family", ["convdiff", "pagerank"])
@pytest.mark.parametrize("reduction", ["blocking", "nonblocking", "rdoubling"])
def test_run_shard_matches_jax_run_shard(family, reduction):
    jcfg = japi.RuntimeConfig(monitor=_family_mon(family), reduction=reduction,
                              max_outer=500, record_trace=True)
    rep = _run(family, jcfg)
    if family == "convdiff":
        st_j, _, b, x0 = _convdiff()
        want = japi.run_shard("convdiff", jcfg, make_shard_mesh(1), 8, x0, b, stencil=st_j)
    else:
        prob, P, x0 = _pagerank()
        want = japi.run_shard("pagerank", jcfg, make_shard_mesh(1), prob.n, x0, P,
                              damping=prob.d)
    assert rep.converged == want.converged is True
    assert rep.outer_iters == want.outer_iters
    assert rep.detect_step == want.detect_step
    assert rep.detected_residual == pytest.approx(want.detected_residual, rel=1e-5)
    np.testing.assert_allclose(rep.residual_history, want.residual_history, rtol=5e-5)
    np.testing.assert_allclose(rep.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)
    _assert_same_events(rep.trace, want.trace)


def test_timing_runs_append_rerun_segments():
    jcfg = japi.RuntimeConfig(monitor=_jmon(), max_outer=500)
    rep = _run("convdiff", jcfg, timing_runs=2)
    assert [nm for nm, _ in rep.wall_segments] == ["build", "run", "rerun", "rerun"]
    assert all(s > 0 for _, s in rep.wall_segments)


def test_record_trace_attaches_schema_valid_trace():
    jcfg = japi.RuntimeConfig(monitor=_jmon(), max_outer=500, record_trace=True)
    rep = _run("convdiff", jcfg)
    rep.trace.validate()
    assert rep.trace.meta["outer_iters"] == rep.outer_iters
    # the trace's wall is the steady-state run segment, not the first run
    assert rep.trace.meta["wall_s"] == dict(rep.wall_segments)["run"]
    assert rep.residual_history.size > 0
    assert np.isfinite(rep.residual_history).all()


def test_no_record_trace_means_no_trace():
    rep = _run("convdiff", japi.RuntimeConfig(monitor=_jmon(), max_outer=500))
    assert rep.trace is None


def test_run_shard_places_inputs_once(monkeypatch):
    """Tensors already on the device reach every run as they are."""
    prob, P, x0 = _pagerank()
    Pt = torch.from_numpy(P)
    cfg = _tcfg(japi.RuntimeConfig(monitor=_family_mon("pagerank"), max_outer=500))
    seen = []

    def spy(*a, **kw):
        run = tsr.make_runtime(*a, **kw)
        return lambda x, arg: seen.append(arg) or run(x, arg)

    monkeypatch.setattr(tapi, "make_runtime", spy)
    tapi.run_shard("pagerank", cfg, 2, prob.n, x0, Pt, damping=prob.d, device="cpu",
                   timing_runs=1)
    assert len(seen) == 3 and all(a.data_ptr() == Pt.data_ptr() for a in seen)


# ---------------------------------------------------------------------------
# Oracle scoring, global residual and reduction facts: equal to JAX's
# ---------------------------------------------------------------------------

_TRACES = [
    [1.0, 0.5, 0.2, 0.09, 0.05, 0.01],
    [3.0, 2.0, 2.5, 1.9],                 # never crosses
    [0.5, 2.0, 0.4, 0.01],                # wanders
    [],
]


@pytest.mark.parametrize("residuals", _TRACES)
@pytest.mark.parametrize("eps", [0.1, 0.05, 1.0])
def test_termination_matches_jax(residuals, eps):
    assert tterm.oracle_detect_step(residuals, eps) == \
        jterm.oracle_detect_step(residuals, eps)
    for step in (None, 0, 2, 3, 10):
        for factor in (10.0, 2.0):
            assert tterm.detection_consistent(step, residuals, eps, factor) == \
                jterm.detection_consistent(step, residuals, eps, factor)
    if residuals:
        assert tterm.stability_band(residuals, eps) == jterm.stability_band(residuals, eps)


@pytest.mark.parametrize("ratio", [0.3, 1.0, 1.01, 9.99, 10.0, 10.1, 437.0, 2.5e7])
def test_decade_margin_matches_jax(ratio):
    assert tterm.decade_margin(ratio) == jterm.decade_margin(ratio)


@pytest.mark.parametrize("safety", [1.0, 2.0, 5.0])
def test_calibrate_margin_matches_jax(safety):
    rs = [1.2e-6, 3.2e-6, 0.8e-6, 2.0e-6]
    def solver():
        it = iter(rs)
        return lambda eps: next(it)

    got = tterm.calibrate_margin(solver(), 1e-6, runs=4, safety=safety)
    want = jterm.calibrate_margin(solver(), 1e-6, runs=4, safety=safety)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("ord", [1.0, 2.0, INF, 3.0, "inf", "max"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_global_residual_matches_jax(ord, dtype):
    rng = np.random.default_rng(3)
    x, fx = rng.standard_normal((5, 7, 9)).astype(dtype), rng.standard_normal((5, 7, 9)).astype(dtype)
    got = tres.global_residual(torch.from_numpy(x), torch.from_numpy(fx), ord)
    want = jres.global_residual(x, fx, ord)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["blocking", "nonblocking", "rdoubling"])
def test_reduction_topology_facts_match_jax(name):
    t, j = tred.get_reduction(name), jred.get_reduction(name)
    for p in (1, 2, 3, 4, 6, 8, 16):
        assert t.usable_shard_count(p) == j.usable_shard_count(p)
        if j.usable_shard_count(p):
            assert t.rounds_per_value(p) == j.rounds_per_value(p)
        else:
            with pytest.raises(ValueError) as ej:
                j.rounds_per_value(p)
            with pytest.raises(ValueError) as et:
                t.rounds_per_value(p)
            assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# Traces: the schema, and port traces read by the JAX package
# ---------------------------------------------------------------------------


def test_event_and_trace_validation_match_jax():
    for mod in (ttrace, jtrace):
        with pytest.raises(ValueError, match="kind"):
            mod.event("barrier", 0.0)
        with pytest.raises(TypeError):
            mod.event("reduce", 0.0, **{"kind": "halo"})
        with pytest.raises(ValueError, match="kind"):
            mod.Trace("test", 1).events_of("barrier")
        tr = mod.Trace("test", 1)
        tr.header["p"] = 0
        with pytest.raises(ValueError, match="worker count"):
            tr.validate()
        tr = mod.Trace("test", 1)
        tr.append({"kind": "sweep", "t": 0.0, "w": 0})
        with pytest.raises(ValueError, match="step"):
            tr.validate()
        assert not mod.validate_trace(tr)
        tr = mod.Trace("test", 1)
        tr.append({"kind": "sweep", "t": float("nan"), "w": 0, "step": 0})
        with pytest.raises(ValueError, match="timestamp"):
            tr.validate()
        with pytest.raises(ValueError, match="schema"):
            mod.Trace.loads(mod.Trace("test", 1).dumps().replace(mod.SCHEMA, "other/9"))
    assert (ttrace.SCHEMA, ttrace.EVENT_KINDS) == (jtrace.SCHEMA, jtrace.EVENT_KINDS)


def test_trace_round_trip_and_series_match_jax(tmp_path):
    tr = ttrace.Trace("test", 4, {"reduction": "nonblocking", "wall_s": 0.5})
    for k in range(5):
        for w in range(4):
            tr.add("sweep", 0.1 * (k + 1), w=w, step=k, inner=2)
        if k % 2:
            tr.add("reduce", 0.1 * (k + 1), step=k, residual=0.9 ** k)
    tr.add("finish", 0.5, step=4, terminated=True)
    tr.validate()
    back = ttrace.Trace.loads(tr.dumps())
    assert back.fingerprint() == tr.fingerprint()
    assert (back.header, back.events) == (tr.header, tr.events)
    path = tmp_path / "trace.jsonl"
    tr.dump(path)
    assert ttrace.Trace.load(path).fingerprint() == tr.fingerprint()
    j = jtrace.Trace.loads(tr.dumps())
    j.validate()
    assert j.fingerprint() == tr.fingerprint()
    assert j.residual_series() == tr.residual_series()
    assert np.isinf(tr.residual_series()[0]) and tr.residual_series()[1] == 0.9
    assert j.events_of("sweep") == tr.events_of("sweep")


@pytest.mark.parametrize("p,knobs", [
    (1, dict(reduction="nonblocking")),
    (4, dict(reduction="rdoubling", inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2),
             contrib_lag=(0, 1, 0, 1))),
    ((2, 2), dict(reduction="nonblocking", halo_delay=(0, 1, 0, 1), mesh_shape=(2, 2))),
    ((2, 1, 2), dict(reduction="blocking", mesh_shape=(2, 1, 2))),
])
def test_shard_adapter_writes_jax_text(p, knobs):
    """``trace_from_shard_run`` on a port run writes the text JAX's adapter
    writes on the same run and config."""
    n = 8
    _, st, b, x0 = _convdiff(n)
    jcfg = japi.RuntimeConfig(monitor=_jmon(), max_outer=500, trace_len=512, **knobs)
    scfg = _tcfg(jcfg).to_shard_config()
    r = tsr.make_convdiff_runtime(scfg, p, st, n, device="cpu")(x0, b)
    assert r.converged
    shards = int(np.prod(p))
    got = ttrace.trace_from_shard_run(r, scfg, shards, 0.25)
    want = jtrace.trace_from_shard_run(r, jcfg.to_shard_config(), shards, 0.25)
    assert got.dumps() == want.dumps()
    if isinstance(p, tuple):
        assert got.events_of("halo")[0]["face"] in ("x-", "x+", "y-", "y+", "z-", "z+")


def _assert_same_events(got, want):
    """A port trace read by JAX: valid, with the events of JAX's trace of
    the same run in kind, worker and step; residuals within rtol 5e-5."""
    j = jtrace.Trace.loads(got.dumps())
    j.validate()
    assert j.fingerprint() == got.fingerprint()
    assert [(e["kind"], e["w"], e["step"]) for e in j.events] == \
        [(e["kind"], e["w"], e["step"]) for e in want.events]
    for a, b in zip(j.events, want.events):
        if "residual" in b:
            assert a["residual"] == pytest.approx(b["residual"], rel=5e-5)
    skip = {"wall_s"}
    assert {k: v for k, v in j.meta.items() if k not in skip} == \
        {k: v for k, v in want.meta.items() if k not in skip}


@pytest.mark.parametrize("family", ["convdiff", "pagerank"])
def test_port_trace_replays_and_calibrates_in_jax(family):
    jcfg = japi.RuntimeConfig(monitor=_family_mon(family), reduction="nonblocking",
                              max_outer=500, record_trace=True)
    rep = _run(family, jcfg)
    assert rep.converged
    tr = jtrace.Trace.loads(rep.trace.dumps())
    cost, report = fit_cost_model(tr)
    v = replay(tr, cost)
    assert v.converged
    assert v.predicted_detect_step == rep.detect_step
    assert v.staleness_steps == 2
    assert not v.approximate
    assert v.predicted_wall_s == pytest.approx(tr.meta["wall_s"], rel=0.02)
    assert report["p_ref"] == 1 and "hop_s" in report["defaulted"]
    # the what-if grid runs on it too
    assert replay(tr, cost, WhatIf(p=4, topology="butterfly")).p == 4


# ---------------------------------------------------------------------------
# The training and elastic entry points
# ---------------------------------------------------------------------------


def _train_problem():
    from repro.solvers.mlfixed import MLFixedPointProblem

    return MLFixedPointProblem(n=8, p=1, m_rows=16, task="lstsq", seed=3)


@pytest.mark.parametrize("kw", [
    dict(reduction="blocking", inner_sweeps=3, max_outer=123, trace_len=7, num_batches=2,
         gamma=0.25),
    dict(reduction="nonblocking", inner_sweeps=(1, 2), halo_delay=(0, 1),
         contrib_lag=(1, 0), num_batches=3, record_trace=True, max_outer=100),
    dict(reduction="rdoubling", halo_delay=2, contrib_lag=1),
])
def test_to_train_config_field_mapping(kw):
    from repro_torch.runtime.train_async import TrainAsyncConfig

    jcfg = japi.RuntimeConfig(monitor=_jmon(), **kw)
    want = jcfg.to_train_config()
    got = _tcfg(jcfg).to_train_config()
    assert isinstance(got, TrainAsyncConfig)
    for f in ("reduction", "inner_steps", "view_delay", "contrib_lag", "num_batches",
              "gamma", "max_rounds", "trace_len"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.monitor == interop.monitor_from(want.monitor)
    assert got.effective_monitor() == interop.monitor_from(want.effective_monitor())


@pytest.mark.parametrize("record", [False, True])
def test_run_train_matches_jax_run_train(record):
    from repro.runtime import train_async as jta
    from repro_torch.runtime import train_async as tta

    prob = _train_problem()
    jcfg = japi.RuntimeConfig(monitor=_jmon(staleness=1), reduction="nonblocking",
                              inner_sweeps=2, max_outer=5000, record_trace=record)
    X0 = jta.init_replicas(prob, 1)
    want = japi.run_train(prob, jcfg, make_shard_mesh(1), X0, prob.A, prob.y)
    got = tapi.run_train(prob, _tcfg(jcfg), 1, X0, prob.A, prob.y, device="cpu",
                         timing_runs=1)
    assert got.converged == want.converged and got.converged
    assert got.outer_iters == want.outer_iters and got.detect_step == want.detect_step
    assert got.detected_residual == pytest.approx(want.detected_residual, rel=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-12, rtol=0)
    np.testing.assert_allclose(got.residual_history, want.residual_history, rtol=5e-5)
    assert [nm for nm, _ in got.wall_segments] == ["build", "run", "rerun"]
    assert got.membership_log == [] and isinstance(got.raw, tta.TrainRunResult)
    legacy = tta.make_train_runtime(prob, _tcfg(jcfg).to_train_config(), 1,
                                    device="cpu")(X0, prob.A, prob.y)
    assert got.outer_iters == legacy.rounds and torch.equal(got.x, legacy.x)
    if record:
        got.trace.validate()
        assert got.trace.source == "train" == want.trace.source
        assert got.trace.meta["reduction"] == "nonblocking"
        assert got.trace.meta["wall_s"] == dict(got.wall_segments)["run"]
        _assert_same_events(got.trace, want.trace)
    else:
        assert got.trace is None


def test_run_train_refuses_indivisible_rows():
    prob = _train_problem()
    cfg = tapi.RuntimeConfig(monitor=interop.monitor_from(_jmon()))
    with pytest.raises(ValueError, match="not divisible"):
        tapi.run_train(prob, cfg, 3, np.zeros((3, 8)), prob.A, prob.y, device="cpu")


def test_run_elastic_matches_jax_run_elastic(tmp_path):
    from repro.runtime import elastic as jel
    from repro_torch.runtime import elastic as tel

    n = 8
    jst, st, b, x0 = _convdiff(n)
    jcfg = japi.RuntimeConfig(monitor=_jmon(staleness=1), reduction="nonblocking",
                              contrib_lag=1, record_trace=True)
    knobs = dict(segment_len=25, max_segments=40)
    want = japi.run_elastic("convdiff", jcfg, n, x0, b, jel.FaultPlan(), str(tmp_path / "a"),
                            stencil=jst, p0=1, **knobs)
    got = tapi.run_elastic("convdiff", _tcfg(jcfg), n, x0, b, tel.FaultPlan(),
                           str(tmp_path / "b"), stencil=st, slots=1, device="cpu", **knobs)
    assert got.converged == want.converged and got.converged
    assert got.outer_iters == want.outer_iters and got.detect_step == want.detect_step
    assert got.detected_residual == pytest.approx(want.detected_residual, rel=5e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-10, rtol=0)
    assert got.membership_log == [tuple(e) for e in want.membership_log]
    assert [nm for nm, _ in got.wall_segments] == ["elastic"]
    assert isinstance(got.raw, tel.ElasticReport)
    got.trace.validate()
    assert got.trace.source == "elastic"
    assert len(got.trace.events_of("segment")) == got.raw.segments_run
    # the same report gives JAX's text
    j = jtrace.Trace.loads(got.trace.dumps())
    assert j.dumps() == got.trace.dumps()
    assert [(e["kind"], e["step"]) for e in j.events] == \
        [(e["kind"], e["step"]) for e in want.trace.events]


def test_train_adapter_writes_jax_text():
    from repro.runtime import train_async as jta
    from repro_torch.runtime import train_async as tta

    prob = MLFixedPointProblemP4()
    jcfg = japi.RuntimeConfig(monitor=_jmon(), reduction="rdoubling",
                              inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2),
                              contrib_lag=(0, 1, 0, 1), num_batches=1, max_outer=5000,
                              trace_len=512)
    tcfg = _tcfg(jcfg).to_train_config()
    r = tta.make_train_runtime(prob, tcfg, 4, device="cpu")(
        jta.init_replicas(prob, 4), prob.A, prob.y)
    assert r.converged
    got = ttrace.trace_from_train_run(r, tcfg, 4, 0.125)
    want = jtrace.trace_from_train_run(r, jcfg.to_train_config(), 4, 0.125)
    assert got.dumps() == want.dumps()
    assert got.source == "train" and got.meta["inner_sweeps"] == [1, 2, 1, 3]


def MLFixedPointProblemP4():
    from repro.solvers.mlfixed import MLFixedPointProblem

    return MLFixedPointProblem(n=16, p=4, m_rows=64, task="logistic", seed=3)


@pytest.mark.parametrize("walls", [None, [0.5, 0.25, 0.125, 1.0, 2.0]])
def test_elastic_adapter_writes_jax_text(tmp_path, walls):
    from repro_torch.runtime import elastic as tel

    n = 8
    _, st, b, x0 = _convdiff(n)
    jcfg = japi.RuntimeConfig(monitor=_jmon(staleness=1), contrib_lag=1)
    scfg = _tcfg(jcfg).to_shard_config()
    rep = tel.run_elastic("convdiff", scfg, n, x0, b, tel.FaultPlan(join_at={1: 1}),
                          str(tmp_path), stencil=st, slots=1, segment_len=5,
                          max_segments=40, device="cpu")
    assert rep.converged and rep.segments_run >= 2
    w = None if walls is None else (walls * 20)[:rep.segments_run]
    got = ttrace.trace_from_elastic_report(rep, scfg, 1, segment_walls=w, meta={"k": 1})
    want = jtrace.trace_from_elastic_report(rep, jcfg.to_shard_config(), 1,
                                            segment_walls=w, meta={"k": 1})
    assert got.dumps() == want.dumps()
    assert [e["change"] for e in got.events_of("member")] == ["join"]


def test_port_train_trace_replays_in_jax():
    from repro.runtime import train_async as jta

    prob = _train_problem()
    # a run the default trace length (512 rounds) covers to its detection
    jcfg = japi.RuntimeConfig(monitor=_jmon(eps_tilde=1e-4, staleness=1), inner_sweeps=2,
                              max_outer=5000, record_trace=True)
    rep = tapi.run_train(prob, _tcfg(jcfg), 1, jta.init_replicas(prob, 1), prob.A, prob.y,
                         device="cpu")
    tr = jtrace.Trace.loads(rep.trace.dumps())
    tr.validate()
    assert tr.source == "train"
    cost, _ = fit_cost_model(tr)
    v = replay(tr, cost)
    assert v.converged
    assert v.predicted_detect_step == rep.detect_step
