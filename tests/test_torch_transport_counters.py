"""The live transport's wire counters (``runtime/transport.py:GroupTransport``,
``core/spans.py:COUNTERS``) on the CPU.

Over a gloo world of 2, under ``spans.recording()``: one ``reduce``, one
``route`` of a face each way and one ``exact`` count exactly their payload
bytes (``wire_bytes``) and backend operations (``collectives``); the
result's ``all_gather`` counts nothing; with no recorder open nothing is
counted; and a PFAIT solve of the 1-D shard loop counts one face, one lane
and three operations an outer iteration, plus its opening exchange.  The
dry transport counts in its group's ``calls`` as before, and nothing
here."""
import numpy as np
import torch

from repro_torch.core import detection, spans
from repro_torch.launch.mesh import dry_shard_group, make_shard_group, spawn_world
from repro_torch.runtime import shard_runtime as tsr
from repro_torch.runtime.transport import DryTransport, GroupTransport
from repro_torch.solvers.convdiff import Stencil

FACE = (8, 8)     # the routed face, f64
N = 16            # the loop's grid, two slabs of 8 planes


def _face(rank: int) -> torch.Tensor:
    return torch.full(FACE, float(rank + 1), dtype=torch.float64)


def _calls(t: GroupTransport, rank: int):
    """One reduce, one route of a face to the peer, one exact; their values
    (numpy: a tensor crosses the result queue by a descriptor that dies
    with the rank)."""
    lane = torch.tensor(float(rank + 1), dtype=torch.float64)
    reduced = t.reduce({rank: lane}, 2.0).wait()
    got = t.route({rank: {(1 - rank, 0): _face(rank)}}).wait()
    exact = t.exact({rank: lane}, 2.0)
    return float(reduced), got[rank][1 - rank, 0].numpy(), float(exact)


def _loop(group):
    """A PFAIT solve of the 1-D shard loop at n = 16 over ``group``."""
    st = Stencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode("pfait", eps_tilde=1e-6, margin=10.0, ord=2.0, staleness=2)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, inner_sweeps=3, max_outer=500, trace_len=500)
    b = np.random.default_rng(0).standard_normal((N, N, N))
    return tsr.make_convdiff_runtime(cfg, group, st, N)(np.zeros_like(b), b)


def _rank_job(rank, k, store):
    group = make_shard_group((k,), "gloo", store=store, rank=rank, device="cpu")
    t = GroupTransport(group)
    with spans.recording() as closed:
        pass
    off = _calls(t, rank)                 # no recorder open
    with spans.recording() as rec:
        on = _calls(t, rank)
    with spans.recording() as gathered:
        t.all_gather({rank: _face(rank)})
    with spans.recording() as solve:
        res = _loop(group)
    outers = solve.totals()["shard.outer"]["count"]
    return {"closed": dict(closed.counts), "off": off, "on": on, "counts": dict(rec.counts),
            "gathered": dict(gathered.counts), "solve": dict(solve.counts),
            "outers": outers, "outer_iters": int(res.outer_iters),
            "converged": bool(res.converged)}


def test_a_live_group_counts_its_wire_exactly_and_only_under_a_recorder(tmp_path):
    ranks = spawn_world(_rank_job, 2, str(tmp_path), timeout=300)
    face_bytes = int(np.prod(FACE)) * 8
    for rank, got in enumerate(ranks):
        # the values are the backend's, counted or not
        for reduced, face, exact in (got["off"], got["on"]):
            assert reduced == 3.0 and exact == np.sqrt(3.0)
            assert np.array_equal(face, _face(1 - rank).numpy())
        # an 8-byte lane each for reduce and exact, one face; one all_reduce
        # each, one isend and one irecv for the face
        assert got["counts"] == {"wire_bytes": 8 + face_bytes + 8, "collectives": 4}
        assert got["closed"] == {} and got["gathered"] == {}
        # a solve: one face to the one peer and one lane (the contribution's
        # float32 partial) an outer iteration, and the opening exchange's face
        k = got["outers"]
        assert got["converged"] and k == got["outer_iters"] > 0
        plane = N * N * 8
        assert got["solve"]["wire_bytes"] == (k + 1) * plane + 4 * k
        assert got["solve"]["collectives"] == 3 * k + 2
        assert set(got["solve"]) <= set(spans.COUNTERS)


def test_the_dry_transport_counts_its_calls_and_not_the_wire():
    group = dry_shard_group(4, rank=1)
    t = DryTransport(group)
    lane = torch.empty((), dtype=torch.float64, device="meta")
    face = torch.empty(FACE, dtype=torch.float64, device="meta")
    face_bytes = int(np.prod(FACE)) * 8
    with spans.recording() as rec:
        t.reduce({1: lane}, 2.0)
        t.route({1: {(0, 0): face, (2, 0): face}}, permutes=2)
    assert group.calls == {("all_reduce", 4): (1, 8),
                           ("collective_permute", 4): (2, 2 * face_bytes)}
    assert rec.counts == {}
