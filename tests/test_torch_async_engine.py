"""The port's event engine (``repro_torch.core.async_engine``) against the
JAX package's on the CPU, run for run: the same seed gives the same sweep
and send events, counters and virtual times, with residuals within the
f32 partials' bars (``tests/_engine_parity.py``).

The matrix here: the two reduction protocols (PFAIT, recursive doubling)
× every platform, fused and unfused, on the convdiff problem (n = 8,
p = 4, at most 600 sweeps a worker) with the hybrid and the Jacobi sweep,
at l∞ and l2 (``test_torch_protocols.py`` runs the snapshot protocols).
Also: the delay models and the block-buffered sampler draw JAX's values,
the presets are equal, an exhausted run returns undetected, membership
checkpoints clone their blocks, and message bytes are the tensors'.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _engine_parity import INF, PLATFORMS, PORT, parity, run
from repro.core import async_engine as jeng
from repro_torch.core import async_engine as teng


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sweep,ord", [("hybrid", INF), ("hybrid", 2.0),
                                       ("jacobi", INF), ("jacobi", 2.0)])
@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("proto", ["pfait", "rdub"])
def test_convdiff_engine_matches_jax(proto, platform, sweep, ord, fused):
    (a, ra, _), (b, rb, prob) = parity("convdiff", proto, ord=ord, sweep=sweep,
                                       platform=platform, fused=fused)
    # fused, a reduction protocol reads no per-sweep residual: one read a
    # sampled contribution, one an exact-residual sample, r* and the
    # detection instant's
    if fused:
        sampled = b.reductions * prob.p if proto == "pfait" else b.reductions
        assert prob.syncs <= sampled + len(rb.residual_samples) + 2


@pytest.mark.parametrize("dist,kw", [("lognormal", dict(sigma=0.7)), ("pareto", dict(shape=1.3)),
                                     ("fixed", {})])
def test_delay_models_draw_jax_values(dist, kw):
    jm = jeng.DelayModel(2e-3, dist=dist, **kw)
    tm = teng.DelayModel(2e-3, dist=dist, **kw)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    np.testing.assert_array_equal(tm.sample(tr, 37), jm.sample(jr, 37))
    assert tm.sample(tr) == jm.sample(jr)
    js, ts = jeng._BufferedSampler(jm, jr, block=16), teng._BufferedSampler(tm, tr, block=16)
    assert [ts() for _ in range(50)] == [js() for _ in range(50)]


@pytest.mark.parametrize("kw", [dict(base=0.0), dict(base=1.0, sigma=-1.0),
                                dict(base=1.0, floor=float("nan")), dict(base=1.0, dist="x"),
                                dict(base=1.0, dist="pareto", shape=0.0)])
def test_delay_model_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError) as want:
        jeng.DelayModel(**kw)
    with pytest.raises(ValueError) as got:
        teng.DelayModel(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["stable", "unstable", "heavy_tail"])
def test_platform_presets_equal_jax(name):
    j, t = jeng.PLATFORMS[name](2e-3), teng.PLATFORMS[name](2e-3)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_exhausted_max_iters_returns_undetected():
    (a, ra, _), (b, rb, _) = parity("convdiff", "pfait", eps=1e-30, max_iters=40)
    assert not b.terminated and b.k_min == 40 and b.detect_time == INF


def test_membership_checkpoint_clones_blocks():
    """A checkpoint-restart run: the restored block is a clone of the
    snapshot (no view of a block the worker went on to replace)."""
    parity("convdiff", "pfait", scenario="crash_restart", eps=1e-12, max_iters=300)
    cfg = dataclasses.replace(teng.stable_platform(1e-3), seed=3, max_iters=300,
                              scenario=PORT["scen"].scenario_registry(1e-3)
                              ["crash_restart"].scenario)
    eng = teng.AsyncEngine(PORT["convdiff"](n=8, p=4, rho=0.9, seed=0), cfg,
                           PORT["proto"].PFAIT(1e-12, ord=INF))
    eng.run()
    assert [k for _, k, _ in eng.scenario.membership_events()] == ["crash", "restore"]
    assert eng.membership_changes == 2
    for snap in eng._ckpt_state:
        x, deps, _ = snap
        assert all(x.data_ptr() != xi.data_ptr() for xi in eng.x)
        assert all(d.data_ptr() != v.data_ptr() for d in deps.values()
                   for dd in eng.deps for v in dd.values())


def test_message_bytes_are_the_tensors():
    (a, _, _), (b, _, prob) = parity("convdiff", "nfais2", platform="stable")
    bx, by, bz = prob.part.block
    faces = sum(len(prob.neighbors(i)) for i in range(prob.p))
    assert b.msg_bytes["data"] == b.msg_counts["data"] * bx * bz * 8 == a.msg_bytes["data"]
    assert faces == 8
    msg = teng.Msg(src=0, dst=1, kind="snap2", payload=torch.zeros(3, 5))
    eng = teng.AsyncEngine(PORT["convdiff"](n=8, p=4, rho=0.9), teng.stable_platform(),
                           PORT["proto"].PFAIT(1.0))
    eng.send(msg, 0.0)
    assert msg.nbytes == 3 * 5 * 4


def test_port_engine_runs_without_jax_problems():
    """The port's engine on the port's problems alone, at each family."""
    for family in ("convdiff", "pagerank", "mlfixed"):
        res, rec, prob = run(PORT, family, "pfait")
        assert res.terminated and res.r_star < 10 * {"convdiff": 1e-6, "pagerank": 1e-9,
                                                      "mlfixed": 1e-6}[family]
