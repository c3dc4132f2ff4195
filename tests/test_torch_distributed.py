"""The process-group transport against the stacked one, on the CPU.

Each world is a local world of spawned gloo ranks (``launch.mesh.spawn_world``,
a ``FileStore`` under ``tmp_path``, no fixed port) that runs many small
configurations one shard per rank (``launch.worlds.run_cases``).  Every run
is held to the same configuration over the stacked transport on the same
inputs: equal iterations, detection and verifications, ``x`` bitwise, the
trace bitwise at l∞ (a max does not depend on order) and within p·2^-24
relative at l2 and l1 (gloo sums the lanes in another order than
``lanes.sum()``).  Every rank must report the same outcome.
"""
import hashlib
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import detection
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.worlds import Case, Inputs, make_inputs, run_cases
from repro_torch.runtime import api
from repro_torch.runtime import shard_runtime as sr

INF = float("inf")
N = 8
HET2 = dict(inner_sweeps=(1, 2), halo_delay=(0, 1), contrib_lag=(1, 0))
HET4 = dict(inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2), contrib_lag=(0, 1, 0, 1))


def _mon(mode, ord=INF, eps=1e-7):
    return detection.for_mode(mode, eps_tilde=eps, margin=10.0,
                              staleness=0 if mode == "sync" else 3, persistence=3, ord=ord)


def _scfg(mode="pfait", ord=INF, eps=1e-7, **kw):
    return sr.ShardRuntimeConfig(monitor=_mon(mode, ord, eps), max_outer=2000,
                                 trace_len=64, **kw)


def _one_d(p, het):
    """The 1-D configurations at shard count p."""
    cd = Inputs("convdiff", N)
    return [
        Case(f"p{p}-blocking", "runtime", _scfg("sync", reduction="blocking"), (p,), cd),
        Case(f"p{p}-hetero", "runtime", _scfg(**het), (p,), cd),
        Case(f"p{p}-hybrid-l2", "runtime", _scfg(ord=2.0, sweep="hybrid", **het), (p,), cd),
        Case(f"p{p}-rdoubling", "runtime", _scfg(reduction="rdoubling", **het), (p,), cd),
        Case(f"p{p}-nfais2", "runtime", _scfg("nfais2", **het), (p,), cd),
        Case(f"p{p}-l1", "runtime", _scfg(ord=1.0, eps=1e-7 * N ** 3, **het), (p,), cd),
        Case(f"p{p}-api-l1", "api", api.RuntimeConfig(
            monitor=_mon("pfait", 1.0, 1e-7 * N ** 3), max_outer=2000, trace_len=64,
            **het), (p,), cd),
    ]


def _world4():
    cd, pr = Inputs("convdiff", N), Inputs("pagerank", 64)
    cases = _one_d(4, HET4)
    for shape in ((2, 2), (1, 2, 2)):
        tag = "x".join(map(str, shape))
        cases += [
            Case(f"{tag}-blocking", "runtime", _scfg("sync", reduction="blocking"), shape, cd),
            Case(f"{tag}-hetero", "runtime", _scfg(**HET4), shape, cd),
            Case(f"{tag}-hetero-overlap", "runtime", _scfg(overlap=True, **HET4), shape, cd),
            Case(f"{tag}-hybrid-nfais2-l2", "runtime",
                 _scfg("nfais2", ord=2.0, sweep="hybrid", **HET4), shape, cd),
            Case(f"{tag}-rdoubling", "runtime", _scfg(reduction="rdoubling"), shape, cd),
        ]
    for red, mode, knobs in (("blocking", "sync", {}), ("nonblocking", "pfait", HET4),
                             ("rdoubling", "pfait", {}), ("nonblocking", "nfais2", {})):
        cases.append(Case(f"pagerank-{red}-{mode}", "api", api.RuntimeConfig(
            monitor=_mon(mode, 1.0, 1e-9), reduction=red, max_outer=2000, trace_len=64,
            **knobs), (4,), pr))
    return cases


WORLDS = {2: _one_d(2, HET2), 4: _world4()}
CASES = {c.name: (k, c) for k, cases in WORLDS.items() for c in cases}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's per-rank results, one spawned gloo world per size."""
    out = {}
    for k, cases in WORLDS.items():
        store = tmp_path_factory.mktemp(f"world{k}")
        out[k] = tmesh.spawn_world(run_cases, k, str(store),
                                   args=("gloo", cases, "cpu"), timeout=300)
    return out


def _stacked(case):
    """The same case over the stacked transport, in this process."""
    x0, arg, kw = make_inputs(case.inputs)
    p = case.shape if len(case.shape) > 1 else case.shape[0]
    if case.kind == "api":
        return api.run_shard(case.inputs.family, case.cfg, p, case.inputs.n, x0, arg,
                             device="cpu", **kw).raw
    return sr.make_runtime(case.inputs.family, case.cfg, p, case.inputs.n, device="cpu",
                           **kw)(x0, arg)


def _monitor(case):
    cfg = case.cfg.to_shard_config() if case.kind == "api" else case.cfg
    return cfg.monitor


def _digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def hold_to_stacked(name, got, want, p, ord):
    """The bars of a distributed run against its stacked twin; returns the
    largest relative trace gap."""
    assert got["outer_iters"] == want.outer_iters, name
    assert got["converged"] == bool(want.converged), name
    assert got["verifications"] == int(want.verifications), name
    assert got["x_digest"] == _digest(want.x.numpy()), name
    t, w = got["trace"], want.trace.numpy()
    assert np.array_equal(np.isinf(t), np.isinf(w)), name
    fin = np.isfinite(w)
    gap = float(np.max(np.abs(t[fin] - w[fin]) / np.abs(w[fin]), initial=0.0))
    if np.isinf(ord):
        assert np.array_equal(t, w), name
        assert got["residual"] == float(want.residual), name
    else:
        assert gap <= p * 2.0 ** -24, (name, gap)
        assert got["residual"] == pytest.approx(float(want.residual), rel=p * 2.0 ** -24)
    return gap


@pytest.mark.parametrize("name", list(CASES))
def test_gloo_run_equals_stacked(worlds, name):
    k, case = CASES[name]
    ranks = worlds[k]
    got = next(c for c in ranks[0]["cases"] if c["name"] == name)
    want = _stacked(case)
    assert got["converged"], name
    np.testing.assert_array_equal(got["x"], want.x.numpy())
    hold_to_stacked(name, got, want, k, _monitor(case).ord)


@pytest.mark.parametrize("k", sorted(WORLDS))
def test_every_rank_reports_the_same_outcome(worlds, k):
    """Same converged step, detected residual, trace (the rdoubling visible
    value included) and x on every rank; only rank 0 ships x itself."""
    ranks = worlds[k]
    assert [r["rank"] for r in ranks] == list(range(k))
    for i, case in enumerate(WORLDS[k]):
        first = ranks[0]["cases"][i]
        for r in ranks[1:]:
            c = r["cases"][i]
            assert c["name"] == first["name"] == case.name
            for key in ("outer_iters", "converged", "residual", "verifications", "x_digest"):
                assert c[key] == first[key], (case.name, key)
            np.testing.assert_array_equal(c["trace"], first["trace"])
            assert c["x"] is None
        # CPU tensors go to gloo as they are: nothing is staged
        assert all(r["cases"][i]["staged_bytes"] == 0 for r in ranks)


def test_world_sweeps_went_through_the_kernel_ops(worlds):
    """The ranks' launch counters stay 0 on the CPU (the plain versions
    serve CPU tensors), and are reported per case, by block shape too."""
    for r in worlds[4]:
        for c in r["cases"]:
            assert set(c["launches"]) >= {"fused_sweep_residual", "diff_norm_partials"}
            assert not any(c["launches"].values())
            assert c["launch_shapes"] == {}


def _failing_job(rank, k, store, how):
    """Rank 1 fails while rank 0 waits in a collective."""
    tmesh.make_shard_group((k,), "gloo", store=store, rank=rank, device="cpu")
    if rank == 1:
        if how == "raise":
            raise RuntimeError("rank 1 gives up")
        os._exit(3)
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_failing_rank_ends_the_world(tmp_path, how):
    t0 = time.monotonic()
    # a rank that exits leaves its peer's collective failing too: either
    # report ends the world
    want = "rank 1 gives up" if how == "raise" else \
        "rank 1 exited with code 3|rank 0 failed"
    with pytest.raises(RuntimeError, match=want):
        tmesh.spawn_world(_failing_job, 2, str(tmp_path), args=(how,), timeout=120)
    assert time.monotonic() - t0 < 60   # ended by the failure, not the timeout
    assert not os.listdir(tmp_path)     # the store file is gone


def test_nccl_refuses_ranks_without_a_card_of_their_own(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tmesh.make_shard_group((1,), "nccl", rank=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tmesh.make_shard_group((2,), "nccl", rank=0)   # two ranks, one card
    assert not dist.is_initialized()


def test_gloo_group_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_shard_group((1,), "gloo", rank=0)
    with pytest.raises(ValueError, match="backend"):
        tmesh.make_shard_group((1,), "mpi", rank=0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", [(4,), (3, 2), (2, 1, 3)])
def test_local_slices_tile_the_grid(shape):
    n = 12
    seen = np.zeros((n, n, n), dtype=int)
    for r in range(int(np.prod(shape))):
        sl = tmesh.local_slices("convdiff", shape, n, r)
        seen[sl] += 1
        part = sr.MeshPartition(n, shape)
        assert [s.start for s in sl] == list(part.offsets(r))
    assert (seen == 1).all()
    rows = [tmesh.local_slices("pagerank", 4, 64, r)[0] for r in range(4)]
    assert [(s.start, s.stop) for s in rows] == [(16 * r, 16 * r + 16) for r in range(4)]
    with pytest.raises(ValueError, match="1-D row blocks"):
        tmesh.local_slices("pagerank", (2, 2), 64, 0)


@pytest.mark.parametrize("local", [(0, 1, 2, 3), (2,)])
def test_place_blocks_takes_the_global_array_or_the_local_block(local):
    """Every local shard gets its block, contiguous and in the asked dtype,
    from the global array; a lone local shard takes its block as given;
    any other shape raises."""
    gshape = (8, 8, 8)
    a = np.random.default_rng(0).standard_normal(gshape)
    slices = {r: tmesh.local_slices("convdiff", (2, 2), 8, r) for r in local}
    got = tmesh.place_blocks(a, slices, torch.device("cpu"), torch.float32,
                             gshape=gshape, what="a")
    assert sorted(got) == list(local)
    for r, t in got.items():
        assert t.is_contiguous() and t.dtype == torch.float32
        assert torch.equal(t, torch.as_tensor(a[slices[r]], dtype=torch.float32))
    block = a[slices[local[0]]]
    if len(local) == 1:
        again = tmesh.place_blocks(block, slices, torch.device("cpu"), gshape=gshape)
        assert torch.equal(again[local[0]], torch.as_tensor(block))
    else:
        with pytest.raises(ValueError, match=r"a, got \(4, 4, 8\)"):
            tmesh.place_blocks(block, slices, torch.device("cpu"), gshape=gshape, what="a")
    with pytest.raises(ValueError, match="got"):
        tmesh.place_blocks(a[:3], slices, torch.device("cpu"), gshape=gshape, what="a")


def test_shard_axes_follow_the_axis_names():
    g = tmesh.ShardGroup(shape=(3, 2), rank=5, backend="gloo", device=torch.device("cpu"))
    assert tmesh.shard_axes_of(g) == ("shard_x", "shard_y") == tmesh.shard_axis_names("shard", 2)
    assert tmesh.mesh_coords(g.rank, g.shape) == (2, 1) and g.p == 6
    assert tmesh.shard_axis_names("data", 1) == ("data",)


@pytest.mark.parametrize("staleness", [0, 1, 3])
@pytest.mark.parametrize("mode", ["sync", "pfait", "nfais2", "nfais5"])
def test_reductions_in_flight_decide_as_the_monitor_ring(mode, staleness):
    """The loop's reductions in flight (launched now, waited for and
    consumed K checks later) then ``decide`` give, check by check, the state
    ``detection.step`` gives through its own ring; the trace holds σ of
    each launched value."""
    from repro_torch.runtime.transport import Pending, ReductionPipeline

    cfg = detection.MonitorConfig(mode=mode, eps=1e-3, eps_tilde=1e-3,
                                  staleness=staleness, persistence=2, ord=2.0)
    vals = torch.tensor([9.0, 4.0, 1e-5, 2e-7, 1e-7, 3e-8, 1e-8, 1e-9, 1e-10, 1e-11])
    ring = pipe_state = detection.init_state(cfg, "cpu")
    pipe = ReductionPipeline(cfg.staleness, cfg.ord, len(vals), torch.device("cpu"))
    for v in vals:
        ring = detection.step(cfg, ring, v, exact_residual_fn=lambda: torch.tensor(1e-9))
        pipe.launch(Pending.done(v))
        pipe_state = detection.decide(cfg, pipe_state, pipe.consume(),
                                      exact_residual_fn=lambda: torch.tensor(1e-9))
        for f in ("step", "persist", "phase", "confirm_at", "converged",
                  "detected_residual", "verifications"):
            assert torch.equal(getattr(ring, f), getattr(pipe_state, f)), f
    assert torch.equal(pipe.drain(), torch.sqrt(vals).float())
