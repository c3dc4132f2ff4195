"""The port's scenarios, reliability oracle and engine trace observer
against the JAX package's, on the CPU.

* Every spec of ``scenario_registry()`` (the 8 standard regimes and the 6
  elastic ones) runs under PFAIT on the convdiff problem in both packages:
  the same run (``tests/_engine_parity.py``), the same
  ``detection_report`` verdict, the same ``platform_health``; the elastic
  specs also under NFAIS2, NFAIS5 and recursive doubling.
* The scenario algebra (effects, composition, ``describe``, membership
  timelines, every effect's draws) equals JAX's; ``replay_matches`` holds in
  both; ``nfais5_slack`` is JAX's.
* ``EngineTraceObserver``: the port's trace validates, loads in JAX's
  ``Trace.loads``, and equals JAX's observer trace but for the detect
  event's residual (within the f32 bars).
"""
import dataclasses
import math

import numpy as np
import pytest

from _engine_parity import BASE, INF, JAX, PORT, RTOL, config, f64_floor, parity, run
from repro.core import reliability as jrel
from repro.core import scenarios as jscen
from repro.core import trace as jtrace
from repro_torch.core import reliability as trel
from repro_torch.core import scenarios as tscen
from repro_torch.core import trace as ttrace

NAMES = sorted(tscen.scenario_registry(BASE))
ELASTIC = sorted(tscen.elastic_scenarios(BASE))
FLOOR = dict(f64_floor("convdiff", tuple(sorted(dict(n=8, p=4, rho=0.9, seed=0).items()))))


def _report_equal(got, want, ord=INF):
    g, w = got.to_dict(), want.to_dict()
    assert g.keys() == w.keys()
    for k in g:
        if isinstance(w[k], float) and k not in ("eps", "factor", "t_detect",
                                                 "t_first_below", "latency_overhead"):
            if math.isinf(w[k]) or w[k] == 0.0:
                assert g[k] == w[k], k
            else:
                assert g[k] == pytest.approx(w[k], rel=RTOL[ord],
                                             abs=FLOOR[ord] * (k != "overshoot")), k
        else:
            assert g[k] == w[k], k


def test_registry_matches_jax():
    for base in (BASE, 2e-3):
        j, t = jscen.scenario_registry(base), tscen.scenario_registry(base)
        assert list(t) == list(j) and len(t) == 14
        assert list(tscen.standard_scenarios(base)) == list(jscen.standard_scenarios(base))
        assert list(tscen.elastic_scenarios(base)) == list(jscen.elastic_scenarios(base))
        for name in j:
            js, ts = j[name], t[name]
            assert (ts.name, ts.platform, ts.lossy) == (js.name, js.platform, js.lossy)
            assert ts.scenario.describe() == js.scenario.describe()
            assert ts.scenario.elastic == js.scenario.elastic
            assert ts.scenario.membership_events() == js.scenario.membership_events()
            assert ts.scenario.initially_inactive() == js.scenario.initially_inactive()
            assert ts.scenario.checkpoint_every == js.scenario.checkpoint_every
            for hook in ("channel_effects", "compute_effects", "pause_effects",
                         "membership_effects"):
                assert ([type(e).__name__ for e in getattr(ts.scenario, hook)]
                        == [type(e).__name__ for e in getattr(js.scenario, hook)])


@pytest.mark.parametrize("name", NAMES)
def test_scenario_draws_match_jax(name):
    """Each hook of a scenario, fed the same delays and the same generator
    state, returns JAX's value and leaves the generator where JAX's does."""
    js = jscen.scenario_registry(BASE)[name].scenario
    ts = tscen.scenario_registry(BASE)[name].scenario
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for k, t in enumerate(np.linspace(0.0, 0.4, 97)):
        kind = ("data", "reduce", "snap2", "marker")[k % 4]
        assert ts.channel_delay(t, kind, 1e-3, tr) == js.channel_delay(t, kind, 1e-3, jr)
        assert ts.compute_delay(t, k % 4, 1e-3, tr) == js.compute_delay(t, k % 4, 1e-3, jr)
        assert ts.paused_until(t, k % 4) == js.paused_until(t, k % 4)
    assert tr.random() == jr.random()


@pytest.mark.parametrize("name", NAMES)
def test_every_scenario_under_pfait_matches_jax(name):
    (a, ra, _), (b, rb, prob) = parity("convdiff", "pfait", scenario=name, stride=10)
    _report_equal(trel.detection_report(rb, 1e-6), jrel.detection_report(ra, 1e-6))
    assert (trel.platform_health(rb, prob.p, BASE)
            == _as_port_health(jrel.platform_health(ra, prob.p, BASE)))


def _as_port_health(h):
    """JAX's ``PlatformHealth`` as the port's dataclass (equal fields)."""
    from repro_torch.runtime.fault_tolerance import PlatformHealth

    return PlatformHealth(**dataclasses.asdict(h))


@pytest.mark.parametrize("proto", ["nfais2", "nfais5", "rdub"])
@pytest.mark.parametrize("name", ELASTIC)
def test_elastic_scenarios_under_other_protocols_match_jax(name, proto):
    (a, ra, _), (b, rb, _) = parity("convdiff", proto, scenario=name, stride=10)
    _report_equal(trel.detection_report(rb, 1e-6), jrel.detection_report(ra, 1e-6))


def test_replay_matches_in_both_packages():
    for pkg, rel in ((JAX, jrel), (PORT, trel)):
        cfg = config(pkg, scenario="drop_reorder", seed=5)
        assert rel.replay_matches(lambda: pkg["convdiff"](n=8, p=4, rho=0.9, seed=5), cfg,
                                  lambda pr: pkg["proto"].PFAIT(1e-6, ord=pr.ord),
                                  residual_stride=25)
    _, ra, _ = run(PORT, "convdiff", "pfait", scenario="drop_reorder", seed=0)
    _, rb, _ = run(PORT, "convdiff", "pfait", scenario="drop_reorder", seed=1)
    assert ra.fingerprint() != rb.fingerprint()


@pytest.mark.parametrize("p,m", [(4, 4), (8, 1), (50, 3)])
def test_nfais5_slack_matches_jax(p, m):
    assert trel.nfais5_slack(p, m) == jrel.nfais5_slack(p, m)


def test_oracle_on_hand_built_traces_matches_jax():
    for detect, true, samples in (((4.0, 5e-7), 2e-5, [(0.0, 1.0), (2.0, 9e-7)]),
                                  ((1.5, 8e-7), 9e-7, [(0.0, 1.0), (1.0, 5e-7)]),
                                  (None, None, [(0.0, 1.0)])):
        recs = []
        for rel in (jrel, trel):
            rec = rel.TraceRecorder()
            rec.residual_samples, rec.detect, rec.true_at_detect = samples, detect, true
            recs.append(rel.detection_report(rec, eps=1e-6, factor=10.0).to_dict())
        assert recs[1] == recs[0]


@pytest.mark.parametrize("proto,scenario", [("pfait", "drop_reorder"), ("nfais2", "crash_late"),
                                            ("rdub", None)])
def test_engine_trace_observer_matches_jax(proto, scenario):
    traces = {}
    for key, pkg, tr in (("j", JAX, jtrace), ("t", PORT, ttrace)):
        cfg = config(pkg, scenario=scenario, fifo=False)
        prob = pkg["convdiff"](n=8, p=4, rho=0.9, seed=0)
        obs = tr.EngineTraceObserver(prob.p, meta={"protocol": proto})
        pkg["eng"].AsyncEngine(prob, cfg, pkg["proto"].PROTOCOLS[proto](1e-6, ord=prob.ord),
                               recorder=obs).run()
        traces[key] = obs.trace
    t, j = traces["t"], traces["j"]
    t.validate()
    assert ttrace.validate_trace(t)
    loaded = jtrace.Trace.loads(t.dumps())
    loaded.validate()
    assert loaded.header == j.header
    assert len(loaded.events) == len(j.events)
    for ev_t, ev_j in zip(loaded.events, j.events):
        if ev_j["kind"] == "detect":
            assert ev_t.keys() == ev_j.keys() and ev_t["t"] == ev_j["t"]
            assert ev_t["residual"] == pytest.approx(ev_j["residual"], rel=RTOL[INF],
                                                     abs=FLOOR[INF])
        else:
            assert ev_t == json_roundtrip(ev_j)
    assert j.events_of("finish") and t.events_of("sweep")


def json_roundtrip(ev):
    import json

    return json.loads(json.dumps(ev))


def test_health_flags_straggler_and_pause_in_the_port():
    _, rec, prob = run(PORT, "convdiff", "pfait", scenario="straggler", seed=0)
    assert 0 in trel.platform_health(rec, prob.p, BASE).stragglers
    _, rec, prob = run(PORT, "convdiff", "pfait", scenario="pause_resume", seed=0,
                       max_iters=3000, eps=1e-9)
    health = trel.platform_health(rec, prob.p, BASE)
    assert health.silent_workers == (1,) and health.max_silence >= 200 * BASE
