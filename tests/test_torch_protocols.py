"""The port's detection protocols (``repro_torch.core.protocols``) against
the JAX package's, run for run on the CPU through both engines
(``tests/_engine_parity.py``: equal events, counters, virtual times and
verdicts; residuals within the f32 bars and the f64 floor).

The matrix here: the snapshot protocols (NFAIS2, NFAIS5, the FIFO exact
snapshot) × every platform, fused and unfused, on the convdiff problem
(n = 8, p = 4) with the hybrid and the Jacobi sweep at l∞ and l2; and every
protocol × platform, fused and unfused, on PageRank (n = 128, p = 4, l1)
and on the ML problem (n = 16, p = 4; lstsq at l2, logistic at l∞).
"""
import pytest

from _engine_parity import INF, JAX, PLATFORMS, PORT, PROTOCOLS, parity, run
from repro.core import protocols as jproto
from repro_torch.core import async_engine as teng
from repro_torch.core import protocols as tproto


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sweep,ord", [("hybrid", INF), ("hybrid", 2.0),
                                       ("jacobi", INF), ("jacobi", 2.0)])
@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("proto", ["nfais2", "nfais5", "exact_snapshot"])
def test_convdiff_snapshot_protocols_match_jax(proto, platform, sweep, ord, fused):
    (a, ra, _), (b, rb, prob) = parity("convdiff", proto, ord=ord, sweep=sweep,
                                       platform=platform, fused=fused)
    if a.terminated and proto != "nfais5":
        assert rb.certified_at_detect is not None


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("proto", PROTOCOLS)
def test_pagerank_protocols_match_jax(proto, platform, fused):
    parity("pagerank", proto, platform=platform, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("task,ord", [("lstsq", 2.0), ("logistic", INF)])
@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("proto", PROTOCOLS)
def test_mlfixed_protocols_match_jax(proto, platform, task, ord, fused):
    parity("mlfixed", proto, task=task, ord=ord, platform=platform, fused=fused)


def test_protocol_registry_and_claims_match_jax():
    assert list(tproto.PROTOCOLS) == list(jproto.PROTOCOLS)
    for k, cls in tproto.PROTOCOLS.items():
        j = jproto.PROTOCOLS[k]
        assert (cls.__name__, cls.name, cls.claim) == (j.__name__, j.name, j.claim)


def test_exact_snapshot_requires_fifo_and_rdub_a_power_of_two():
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="requires cfg.fifo=True"):
            run(pkg, "convdiff", "exact_snapshot", fifo=False)
        with pytest.raises(ValueError, match="power-of-two worker count, got p=3"):
            run(pkg, "pagerank", "rdub", p=3, n=96)


def test_pfait_sends_no_protocol_message_and_nfais2_carries_data():
    (_, _, _), (b, _, _) = parity("convdiff", "pfait")
    assert set(b.msg_counts) == {"data"}
    (_, _, _), (b2, _, prob) = parity("convdiff", "nfais2")
    bx, by, bz = prob.part.block
    assert b2.msg_bytes["snap2"] == b2.msg_counts["snap2"] * bx * bz * 8
    (_, _, _), (b5, _, _) = parity("convdiff", "nfais5")
    assert b5.msg_bytes["snap5"] == 16 * b5.msg_counts["snap5"]


@pytest.mark.parametrize("m", [1, 6])
def test_nfais5_persistence_matches_jax(m):
    parity("convdiff", "nfais5", m=m)


def test_snapshot_records_are_clones():
    """A record is a copy of the block at the recording instant, never a
    view of a block the worker goes on to replace."""
    res, rec, prob = run(PORT, "convdiff", "nfais2")
    assert res.terminated
    cfg = teng.stable_platform(1e-3)
    eng = teng.AsyncEngine(PORT["convdiff"](n=8, p=4, rho=0.9, seed=0), cfg,
                           tproto.NFAIS2(1e-6, ord=INF))
    eng.run()
    rec_own = eng.protocol.recorded_vector()
    assert rec_own is not None
    assert all(r.data_ptr() != x.data_ptr() for r in rec_own for x in eng.x)
