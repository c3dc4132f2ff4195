"""The port's trace replay and calibration (``repro_torch.sim``) against the
JAX package's (``repro.sim``), on the CPU: ``replay``, ``what_if_table``,
``fit_cost_model``, ``fit_delay_model`` and ``engine_config_from_fit``
(and the pieces under them) give JAX's values within 1e-12, on traces the
JAX package writes (its synthetic device traces, its event engine's) and
on traces the port writes (``run_shard``'s, its event engine's).  Each
trace is read by both packages from the same JSONL text.
"""
import dataclasses
import math

import numpy as np
import pytest

from _engine_parity import JAX, PORT, config
from repro.core import trace as jtrace
from repro.sim import calibrate as jcal
from repro.sim import replay as jrep
from repro_torch import sim as tsim
from repro_torch.core import detection as tdet
from repro_torch.core import trace as ttrace
from repro_torch.runtime import api as tapi
from repro_torch.sim import calibrate as tcal
from repro_torch.sim import replay as trep
from repro_torch.solvers.convdiff import Stencil, make_rhs
from repro_torch.solvers.pagerank import PageRankProblem

TOL = 1e-12


def _close(got, want):
    """Equal, floats within rtol 1e-12, through dataclasses, dicts and lists."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, float) and not isinstance(want, bool):
        if math.isinf(want) or math.isnan(want):
            assert got == want or (math.isnan(got) and math.isnan(want))
        else:
            assert got == pytest.approx(want, rel=TOL, abs=0.0)
    else:
        assert got == want


def _synthetic(p, mode, reduction, topology="flat", steps=120, staleness=2):
    tr = jtrace.Trace("synthetic", p, {
        "reduction": reduction, "topology": topology,
        "monitor": {"mode": mode, "eps": 1e-4, "eps_tilde": 1e-4, "staleness": staleness,
                    "persistence": 4, "ord": 2.0, "check_every": 1},
        "inner_sweeps": [1 + (w % 3) for w in range(p)], "halo_delay": [w % 2 for w in range(p)],
        "contrib_lag": [0] * p, "wall_s": 1.25, "outer_iters": steps, "synthetic_t": True,
    })
    for k in range(steps):
        for w in range(p):
            tr.add("sweep", float(k + 1), w=w, step=k)
        tr.add("reduce", float(k + 1), step=k, residual=0.9 ** k)
    return tr.dumps()


def _engine_text(pkg, tr_mod, proto, p=4):
    prob = pkg["convdiff"](n=8, p=p, rho=0.9, seed=0)
    cfg = config(pkg, platform="unstable")
    obs = tr_mod.EngineTraceObserver(prob.p)
    res = pkg["eng"].AsyncEngine(prob, cfg, pkg["proto"].PROTOCOLS[proto](1e-6, ord=prob.ord),
                                 recorder=obs).run()
    # what a calibration run adds: the run's wall and outer count
    obs.trace.meta.update(wall_s=res.wtime, outer_iters=res.k_max, reduction="nonblocking",
                          monitor={"mode": "pfait", "eps": 1e-6, "eps_tilde": 1e-6,
                                   "staleness": 0, "persistence": 4, "ord": 2.0})
    for k in range(res.reductions):
        obs.trace.add("reduce", float(k), step=k, residual=0.8 ** k)
    return obs.trace.dumps()


def _shard_text(family, reduction):
    mon = tdet.for_mode("pfait", eps_tilde=1e-6 if family == "convdiff" else 1e-9,
                        staleness=2, ord=2.0 if family == "convdiff" else 1.0)
    cfg = tapi.RuntimeConfig(monitor=mon, reduction=reduction, max_outer=500,
                             record_trace=True)
    p = 4 if reduction == "rdoubling" else 2
    if family == "convdiff":
        st = Stencil.for_contraction(8, 1.0, (1.0, 1.0, 1.0), rho=0.9)
        b = make_rhs(8, seed=0)
        rep = tapi.run_shard("convdiff", cfg, p, 8, np.zeros_like(b), b, stencil=st,
                             device="cpu")
    else:
        prob = PageRankProblem(n=64, p=4, seed=0)
        rep = tapi.run_shard("pagerank", cfg, p, 64, np.full(64, 1 / 64), prob.to_dense(),
                             damping=prob.d, device="cpu")
    assert rep.converged
    return rep.trace.dumps()


TRACES = {
    "jax-synthetic-pfait": lambda: _synthetic(8, "pfait", "nonblocking"),
    "jax-synthetic-blocking": lambda: _synthetic(8, "sync", "blocking", staleness=0),
    "jax-synthetic-butterfly": lambda: _synthetic(8, "pfait", "rdoubling", "butterfly"),
    "jax-synthetic-nfais2": lambda: _synthetic(6, "nfais2", "nonblocking"),
    "jax-synthetic-nfais5": lambda: _synthetic(6, "nfais5", "nonblocking"),
    "jax-engine": lambda: _engine_text(JAX, jtrace, "pfait"),
    "port-engine": lambda: _engine_text(PORT, ttrace, "pfait"),
    "port-engine-nfais2": lambda: _engine_text(PORT, ttrace, "nfais2"),
    "port-shard-convdiff": lambda: _shard_text("convdiff", "nonblocking"),
    "port-shard-pagerank-blocking": lambda: _shard_text("pagerank", "blocking"),
    "port-shard-rdoubling": lambda: _shard_text("convdiff", "rdoubling"),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_replay_and_calibration_match_jax(name):
    text = TRACES[name]()
    jt, tt = jtrace.Trace.loads(text), ttrace.Trace.loads(text)
    tt.validate()
    assert tt.fingerprint() == jt.fingerprint()
    assert tt.residual_series() == jt.residual_series()
    for kw in (dict(), dict(hop_s=2e-5), dict(residual_pass_s=3e-4),
               dict(hop_s=1e-5, residual_pass_s=1e-4)):
        jcost, jrepo = jcal.fit_cost_model(jt, **kw)
        tcost, trepo = tcal.fit_cost_model(tt, **kw)
        _close(tcost, jcost)
        _close(trepo, jrepo)
    p = jt.p
    what_ifs = [None, trep.WhatIf(p=2 * p), trep.WhatIf(topology="tree"),
                trep.WhatIf(topology="flat-blocking", stragglers={0: 3.0}),
                trep.WhatIf(p=8, topology="butterfly", hop_s=1e-4),
                trep.WhatIf(p=3, topology="flat-nonblocking")]
    for wi in what_ifs:
        jwi = None if wi is None else jrep.WhatIf(**dataclasses.asdict(wi))
        _close(trep.replay(tt, tcost, wi), jrep.replay(jt, jcost, jwi))
    _close(trep.what_if_table(tt, tcost, (1, 2, 4, 6, 8)),
           jrep.what_if_table(jt, jcost, (1, 2, 4, 6, 8)))


@pytest.mark.parametrize("dist", ["lognormal", "pareto", "fixed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_delay_fit_and_engine_config_match_jax(dist, seed):
    x = 1e-3 * np.random.default_rng(seed).lognormal(0.0, 0.3, size=64)
    for alpha in (0.05, 0.01):
        jm, jr = jcal.fit_delay_model(x, dist=dist, alpha=alpha)
        tm, tr = tcal.fit_delay_model(x, dist=dist, alpha=alpha)
        _close(tm, jm)
        _close(tr, jr)
    for hop in (None, 2e-4):
        _close(tcal.engine_config_from_fit(tm, hop), jcal.engine_config_from_fit(jm, hop))
    with pytest.raises(ValueError):
        tcal.fit_delay_model([1e-3])
    with pytest.raises(ValueError):
        tcal.fit_delay_model(x, dist="gamma")


@pytest.mark.parametrize("topology", trep.TOPOLOGIES)
@pytest.mark.parametrize("K", [0, 3])
def test_monitor_replay_and_virtual_clock_match_jax(topology, K):
    series = 0.85 ** np.arange(90) * (1 + 0.1 * np.sin(np.arange(90)))
    for p in (1, 4, 8):
        _close(trep.visible_series(series, topology, K, p).tolist(),
               jrep.visible_series(series, topology, K, p).tolist())
        for mode in ("pfait", "sync", "nfais2", "nfais5"):
            _close(trep.replay_monitor(series, mode, 1e-4, 2e-4, K, 4, topology, p),
                   jrep.replay_monitor(series, mode, 1e-4, 2e-4, K, 4, topology, p))
        cost = dict(sweep_s=1e-3, hop_s=5e-5, residual_pass_s=2e-4, p_ref=4)
        inner, delay = np.arange(p) % 3 + 1, np.arange(p) % 2
        straggler = np.ones(p)
        straggler[0] = 2.5
        _close(trep.predict_wall(40, p, inner, delay, straggler, trep.CostModel(**cost),
                                 topology),
               jrep.predict_wall(40, p, inner, delay, straggler, jrep.CostModel(**cost),
                                 topology))


def test_package_exports_and_ks_match_jax():
    assert tsim.replay_trace is trep.replay
    assert tsim.fit_cost_model is tcal.fit_cost_model
    assert trep.TOPOLOGIES == jrep.TOPOLOGIES
    assert tcal.DEFAULT_HOP_FRACTION == jcal.DEFAULT_HOP_FRACTION
    x = np.random.default_rng(3).lognormal(size=50)
    _close(tcal.ks_statistic(x, lambda v: 1 - np.exp(-v)),
           jcal.ks_statistic(x, lambda v: 1 - np.exp(-v)))
    for bad in (dict(sweep_s=-1.0, hop_s=0.0, residual_pass_s=0.0, p_ref=1),
                dict(sweep_s=1.0, hop_s=0.0, residual_pass_s=0.0, p_ref=0)):
        with pytest.raises(ValueError):
            trep.CostModel(**bad)
    with pytest.raises(ValueError):
        trep.WhatIf(topology="ring")
