"""``correct`` comes out false for the control and for each fault the
cells can have, planted underneath the program's timed path on every
rank, on the CPU at tiny sizes (the run skips only the look for a card).
A fault is a module-level function that every rank calls with
``patch(obj, name, value)`` before set-up (``world.planted``)."""
from __future__ import annotations

import json
import multiprocessing
import time

import pytest
import torch
import torch.distributed as dist

from perfbench import harness, profile, spec
from perfbench.tests._tiny import cells, digest, tiny_root
from repro_torch.runtime import shard_runtime as sr
from repro_torch.runtime import transport as tp


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, **kw):
    cell = spec.load(f"tiny-{workload}", root)
    run = harness.run_cell(cell, 2 ** 32 + 9, 0.3, False, "cpu", time.perf_counter(),
                           root=root, **kw)
    return harness.passes(run.checks), run.checks


def _wrap_loop(patch, change):
    make = sr._make_loop

    def patched(cfg, transport, mesh_shape=None):
        loop = make(cfg, transport, mesh_shape)
        return lambda prob, xs: loop(change(prob), xs)
    patch(sr, "_make_loop", patched)


def unchanged_state(patch):
    def change(prob):
        return prob._replace(sweep=lambda i, x, g: x, sweep_contribs=None,
                             sweep_contrib=lambda i, x, g: (x, prob.sweep_contrib(i, x, g)[1]))
    _wrap_loop(patch, change)


def half_the_shards(patch):
    """The reduction over the lower half of the shards, scaled to the whole:
    stacked, the lanes of the rest left out; over a group, the upper half of
    the ranks sends nought."""
    def stacked(self, lanes, ord):
        keep = [lanes[i] for i in sorted(lanes)[:max(1, len(lanes) // 2)]]
        return tp.Pending.done(tp._preduce(torch.stack(keep), ord) * (len(lanes) / len(keep)))

    reduce = tp.GroupTransport.reduce

    def group(self, lanes, ord):
        keep = max(1, self.p // 2)
        scale = self.p / keep if self.group.rank < keep else 0.0
        return reduce(self, {i: v * scale for i, v in lanes.items()}, ord)
    patch(tp.StackedTransport, "reduce", stacked)
    patch(tp.GroupTransport, "reduce", group)


def no_exchange(patch):
    def change(prob):
        first = []

        def exchange(xs):
            if not first:
                first.append(prob.exchange(xs))
            return first[0]
        return prob._replace(exchange=exchange)
    _wrap_loop(patch, change)


def altered_answer(patch):
    result = sr._result

    def patched(*args, **kw):
        r = result(*args, **kw)
        return r._replace(x=r.x * (1 + 1e-6))
    patch(sr, "_result", patched)


FAULTS = [unchanged_state, half_the_shards, no_exchange, altered_answer]


def a_follower_raises(patch):
    """Rank 1 of a world raises at its first solve's result."""
    result = sr._result

    def patched(*args, **kw):
        if dist.is_initialized() and dist.get_rank() == 1:
            raise RuntimeError("a failure planted on rank 1")
        return result(*args, **kw)
    patch(sr, "_result", patched)


def test_sound_runs_pass(root):
    for w in cells():
        ok, checks = _run(root, w)
        assert ok, (w, checks)


@pytest.mark.parametrize("workload", cells())
def test_the_control_in_float32_fails(root, workload):
    ok, checks = _run(root, workload, control=torch.float32)
    assert not ok, checks


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", cells())
def test_a_planted_fault_fails(root, workload, fault):
    ok, checks = _run(root, workload, plant=fault)
    assert not ok, checks
    assert sr._make_loop.__module__ == sr.__name__ and sr._result.__module__ == sr.__name__


def test_a_cell_on_several_chips_needs_only_new_files(tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    before = digest(root)
    cfg = json.loads((root / "perfbench/configs/tiny-convdiff-n1024-p256.json").read_text())
    cfg.update(shards=4, backend="gloo", rho=0.5)
    (root / "perfbench/configs/convdiff-n16-p4.gloo.json").write_text(json.dumps(cfg))
    (root / "perfbench/metrics/outer_spans.py").write_text(
        "def read(ctx):\n"
        "    outer = getattr(ctx, 'span_totals', {}).get('shard.outer')\n"
        "    return outer['count'] if outer else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "convdiff-n16-p4.gloo",
                             "source": "https://arxiv.org/abs/2206.15418",
                             "file": "perfbench/configs/convdiff-n16-p4.gloo.json",
                             "reduced": ["n", "rho"], "why": "one shard a rank"})
    bench["workloads"].append({"name": "convdiff-n16-p4.gloo.pfait",
                               "config": "convdiff-n16-p4.gloo", "traffic": "pfait-k4-inner4",
                               "chips": 4, "why": "a cell on four chips"})
    bench["per_layer"].append({"name": "outer_spans", "unit": "outer", "better": "higher",
                               "source": "program_span", "layer": "shard loop",
                               "moves": "outer_ms", "workloads": ["convdiff-n16-p4.gloo.pfait"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {k: v for k, v in digest(root).items() if k in before} == before

    cell = spec.load("convdiff-n16-p4.gloo.pfait", root)
    monkeypatch.setattr(harness, "PROFILE_S", 0.0)
    monkeypatch.setattr(harness, "SYNC_S", 0.0)
    monkeypatch.setattr(profile, "profiled", lambda work: {
        "outers": work(), "window_s": 1.0, "busy_s": 0.5, "kernel_count": 10, "kernel_s": 0.1,
        "breakdown": {"device_ops": [], "idle_gaps": []}})
    monkeypatch.setattr(profile, "count_syncs", lambda work: (lambda o: (o + 2, o))(work()))

    def run(seconds=0.3, trace=False, **kw):
        return harness.run_cell(cell, 2 ** 32 + 5, seconds, trace, "cpu", time.perf_counter(),
                                root=root, **kw)

    # one host thread a rank, as a run on the card has: four ranks share the cores
    monkeypatch.setattr(torch, "get_num_threads", lambda: 1)

    # long enough for two detections or more (ρ = 0.5 converges in a few
    # outer iterations), each certified as its solve ends
    sound = run(seconds=1.0, trace=True)
    assert harness.passes(sound.checks), sound.checks
    assert list(sound.setup_stages)[:2] == ["process and imports", "the world's ranks"]
    assert sound.forbidden == []
    assert sum(s.converged for s in sound.solves) >= 2
    assert all(s.r_over_eps is not None for s in sound.solves if s.converged)
    got = harness.per_layer(cell, sound, "cpu", root)
    assert got["outer_spans"] == sum(s.outer for s in sound.solves) > 0
    assert got["dispatch_ms_per_outer"] > 0 and got["sync_wait_ms_per_outer"] > 0
    assert not harness.passes(run(control=torch.float32).checks)
    for fault in FAULTS:
        assert not harness.passes(run(plant=fault).checks), fault.__name__
    with pytest.raises(RuntimeError, match="a failure planted on rank 1"):
        run(plant=a_follower_raises)
    assert multiprocessing.active_children() == []
    assert not dist.is_initialized()
