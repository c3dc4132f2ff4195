"""The harness's pieces on the CPU: finding files by name, the result
line, the isolation of what runs on the card, the copied work counts and
the profiler-trace reduction."""
from __future__ import annotations

import ast
import json
import math
import random
import re
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, profile, spec
from perfbench import world as wd
from perfbench.metrics import _roofline
from perfbench.tests._tiny import cells, digest, tiny_root
from perfbench.traffic import Mix, solve_seed

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", cells())
def test_cell_files_are_found_by_name(workload):
    cell = spec.load(workload)
    assert cell.config["family"] == "convdiff"
    Mix.read(cell.traffic)
    assert hasattr(spec.family(cell), "Problem")
    readers = spec.readers(cell)
    assert set(readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r.read) for r in readers.values())
    assert {"outer_ms", "setup_s"} <= {m["name"] for m in cell.end_to_end}


def test_names_units_and_lengths_keep_to_the_contract():
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert wd.ranks(spec.load(w["name"])) in (0, w["chips"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (spec.ROOT / c["file"]).is_file()
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (spec.ROOT / "PERF.md").read_text()
    assert all(f"**{layer}**" in perf for layer in layers)


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    root = tiny_root(tmp_path)
    before = digest(root)
    cfg = json.loads((root / "perfbench/configs/tiny-convdiff-n1024-p256.json").read_text())
    cfg["n"] = 8
    (root / "perfbench/configs/convdiff-n8-p2.json").write_text(json.dumps(dict(cfg, shards=2)))
    mix = json.loads((root / "perfbench/traffic/pfait-k4-inner4.json").read_text())
    mix["knobs"]["inner_sweeps"] = 2
    (root / "perfbench/traffic/pfait-k2-inner2.json").write_text(json.dumps(mix))
    (root / "perfbench/metrics/outer_count.py").write_text(
        "def read(ctx):\n    return ctx.outers\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "convdiff-n8-p2", "source": "https://arxiv.org/abs/2206.15418",
                             "file": "perfbench/configs/convdiff-n8-p2.json", "reduced": ["n"],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": "convdiff-n8-p2.k2", "config": "convdiff-n8-p2",
                               "traffic": "pfait-k2-inner2", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "outer_count", "unit": "outer", "better": "higher",
                               "source": "program_counter", "layer": "shard loop",
                               "moves": "outer_ms", "workloads": ["convdiff-n8-p2.k2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    files = {k: v for k, v in digest(root).items() if k in before}
    assert files == before
    cell = spec.load("convdiff-n8-p2.k2", root)
    run = harness.run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter(), root=root)
    assert harness.passes(run.checks), run.checks
    run.traced = {"outers": 7, "window_s": 1.0, "busy_s": 0.5, "kernel_count": 70,
                  "kernel_s": 0.4, "syncs": 7, "sync_outers": 7, "breakdown": {}}
    got = harness.per_layer(cell, run, "cpu", root)
    assert got["outer_count"] == 7 and got["launches_per_outer"] == 10


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_format(tmp_path, trace):
    root = tiny_root(tmp_path)
    cell = spec.load("tiny-convdiff-n1024-p256.blocking", root)
    run = harness.run_cell(cell, 2 ** 31 + 17, 0.3, False, "cpu", time.perf_counter(), root=root)
    if trace:
        run.traced = {"outers": 20, "window_s": 0.5, "busy_s": 0.2, "kernel_count": 400,
                      "kernel_s": 0.15, "syncs": 21, "sync_outers": 20,
                      "span_totals": {"shard.outer": {"count": 20, "seconds": 2.1,
                                                      "self_seconds": 0.1},
                                      "shard.sync": {"count": 20, "seconds": 0.2,
                                                     "self_seconds": 0.2}},
                      "counts": {"host_syncs": 22}, "kernel_flops": 1e9, "kernel_bytes": 1e9,
                      "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["aten::mv", 0.2]]}}
    res = json.loads(json.dumps(harness.result(cell, run, bool(trace), "NVIDIA H100 80GB HBM3",
                                               root)))
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    for m in want:
        if m["name"] in res["metrics"]:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
            assert res["metrics"][m["name"]]["value"] > 0
    assert ("breakdown" in res) == bool(trace)
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
    assert all({"value", "limit"} == set(c) for c in res["checks"].values())


def test_run_refuses_without_a_card(capsys, monkeypatch):
    from perfbench import run as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--workload", "convdiff-n1024-p256.blocking", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_are_named_by_whole_top_level_name(monkeypatch):
    from perfbench import run as cli

    for name in [m for m in list(sys.modules) if m.split(".")[0] in cli.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert cli.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert cli.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert cli.forbidden_loaded() == ["repro"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(spec.ROOT).as_posix() for p in
                                        (spec.ROOT / "perfbench").rglob("*.py")
                                        if "tests" not in p.parts))
def test_nothing_that_runs_on_the_card_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(spec.ROOT / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "/reference/" in path:
        assert "repro_torch" not in tops, tops


def test_copied_work_counts_match_the_kernels_at_the_cell_block():
    from repro_torch.kernels.jacobi3d import jacobi3d
    from repro_torch.kernels.residual_norm import residual_norm

    cell = spec.load("convdiff-n1024-p256.pfait")
    cfg, mix = cell.config, Mix.read(cell.traffic)
    n, p = cfg["n"], cfg["shards"]
    block = (n // p, n, n)
    cells_ = math.prod(block)
    item = _roofline.ITEMSIZE[cfg["dtype"]]
    sweep_ops, sweep_bytes = jacobi3d.work(block, item, "sweep")
    res_ops, _ = jacobi3d.work(block, item, "residual")
    norm_ops, _ = residual_norm.work(cells_, item)
    nbytes, ops = _roofline.convdiff_outer(cfg, mix)
    assert ops == p * (mix.inner_sweeps * sweep_ops + norm_ops)
    blocking = Mix.read(spec.load("convdiff-n1024-p256.blocking").traffic)
    assert _roofline.convdiff_outer(cfg, blocking)[1] == p * (4 * sweep_ops + res_ops)
    # the least bytes: x and b read and x written once; the kernels move more
    assert nbytes == 3 * item * n ** 3 < p * mix.inner_sweeps * sweep_bytes


def test_solve_seeds_are_distinct_and_fit_63_bits():
    seeds = {solve_seed(s, i) for s in (0, 1, 2 ** 31 + 5, 2 ** 40) for i in range(-1, 50)}
    assert len(seeds) == 4 * 51 and max(seeds) < 2 ** 63


def test_trace_reduction_unions_device_time_and_labels_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": profile.WINDOW, "ts": 0, "dur": 100,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 10, "dur": 30, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 15, "dur": 5, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 90, "dur": 10}]
    got = profile.read_trace(ev)
    assert got["outers"] is None and got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(45e-6)
    assert got["kernel_count"] == 3 and got["kernel_s"] == pytest.approx(30e-6)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps["aten::cat"] == pytest.approx(25e-6)
    assert gaps["host, outside any operator"] == pytest.approx(30e-6)
    assert dict(got["breakdown"]["device_ops"])["k1"] == pytest.approx(20e-6)


def _ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _kernel(ts, dur, corr=None, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 3,
            "tid": 1, "args": {"correlation": corr}}


def _idle_pct(reading):
    reader = spec.load_module(spec.ROOT / "perfbench" / "metrics" / "idle_pct.py")
    return reader.read(SimpleNamespace(**reading))


def test_a_host_stall_before_the_outer_spans_is_no_idle_time():
    # 0.5 s of host stall (the profiler's start, say), then 8 outer
    # iterations of 0.25 s with the device busy all through them
    ev = [_ann(profile.WINDOW, 0, 2.5e6)]
    for k in range(8):
        t = 0.5e6 + k * 0.25e6
        ev += [_ann(profile.OUTER, t, 0.25e6), _launch(t, k), _kernel(t + 5, 0.25e6 - 5, k)]
    got = profile.read_trace(ev)
    assert got["outers"] == 8 and got["kernel_count"] == 8
    assert got["window_s"] == pytest.approx(2.0)
    assert 0 <= _idle_pct(got) < 1


def test_the_gaps_between_solves_are_no_idle_time():
    # two solves of two outer iterations each; between them the result, the
    # next solve's start and its draw, with the device idle
    ev = [_ann(profile.WINDOW, 0, 1300)]
    for t in (0, 100, 1000, 1100):
        ev += [_ann(profile.OUTER, t, 100), _kernel(t, 100, name="sweep")]
    ev += [_kernel(400, 50, name="gather")]
    got = profile.read_trace(ev)
    assert got["window_s"] == pytest.approx(400e-6) and got["busy_s"] == pytest.approx(400e-6)
    assert _idle_pct(got) == 0 and got["breakdown"]["idle_gaps"] == []
    assert got["kernel_count"] == 4 and dict(got["breakdown"]["device_ops"]) == {
        "sweep": pytest.approx(400e-6)}


def test_a_trace_without_outer_spans_reads_over_its_window_annotations():
    # a follower's calls, each in a window of its own: the reading runs from
    # the first call's start to the last one's end
    ev = [_ann(profile.WINDOW, 0, 100), _ann(profile.WINDOW, 300, 100),
          _ann("shard.solve", 0, 100), _kernel(10, 40), _kernel(310, 40)]
    got = profile.read_trace(ev)
    assert got["outers"] is None
    assert got["window_s"] == pytest.approx(400e-6) and got["busy_s"] == pytest.approx(80e-6)
    assert got["kernel_count"] == 2
    # outer spans on another thread than the window's are not this work's
    got = profile.read_trace(ev + [_ann(profile.OUTER, 0, 100, tid=2)])
    assert got["outers"] is None and got["window_s"] == pytest.approx(400e-6)


def test_kernels_are_tied_to_their_launches_by_correlation_id():
    ev = [_ann(profile.WINDOW, 0, 400), _ann(profile.OUTER, 100, 100),
          # launched inside, run after the span: counted, but not busy in it
          _launch(150, 7), _kernel(210, 50, 7),
          # launched before the span, run inside it: busy, but not counted
          _launch(50, 8), _kernel(120, 20, 8),
          # no launch in the trace: counted by its start
          _kernel(160, 10, 9),
          # launched and run before the span: neither
          _launch(10, 10), _kernel(20, 30, 10)]
    got = profile.read_trace(ev)
    assert got["outers"] == 1 and got["window_s"] == pytest.approx(100e-6)
    assert got["kernel_count"] == 2 and got["kernel_s"] == pytest.approx(60e-6)
    assert got["busy_s"] == pytest.approx(30e-6)


@pytest.mark.parametrize("seed", range(4))
def test_busy_time_never_passes_the_window(seed):
    rng = random.Random(seed)
    for _ in range(100):
        ev, corr, t = [], 0, rng.uniform(0, 1e6)
        start = t
        for _ in range(rng.randint(1, 4)):               # solves
            t += rng.choice([0, rng.expovariate(1e-4)])  # a stall before the solve
            for _ in range(rng.randint(1, 6)):           # its outer iterations
                dur = rng.uniform(10, 5e4)
                ev.append(_ann(profile.OUTER, t, dur))
                share, lag = rng.random(), rng.uniform(-50, 500)
                for _ in range(rng.randint(0, 20)):
                    corr += 1
                    launch = t + rng.uniform(0, dur)
                    ev += [_launch(launch, corr),
                           _kernel(launch + lag, rng.uniform(0, 2 * share * dur / 5), corr)]
                t += dur + rng.choice([0, rng.uniform(0, 10)])
            t += rng.uniform(0, 1e4)
        ev.append(_ann(profile.WINDOW, start, t - start))
        if rng.random() < 0.2:   # the fallback, without outer spans
            ev = [e for e in ev if e["name"] != profile.OUTER]
        got = profile.read_trace(ev)
        assert 0 <= got["busy_s"] <= got["window_s"] and got["window_s"] > 0
        assert 0 <= _idle_pct(got) <= 100
        idle = sum(v for _, v in got["breakdown"]["idle_gaps"])
        assert idle == pytest.approx(got["window_s"] - got["busy_s"], abs=1e-9)


def _linear(outers: int) -> dict:
    """Readings of a sub-window: a fixed cost for the solve's start and
    result, and a steady cost an outer iteration."""
    return {"outers": outers, "window_s": 0.3 + 0.2 * outers, "busy_s": 0.1 + 0.05 * outers,
            "kernel_count": 40 + 7 * outers, "kernel_s": 0.01 + 0.04 * outers,
            "breakdown": {"device_ops": [["k", 0.04 * outers]], "idle_gaps": []}}


@pytest.mark.parametrize("workload", cells())
def test_traced_readings_are_the_long_sub_window_less_the_short(tmp_path, monkeypatch, workload):
    """The traced run's readings, under the real profiler on the CPU: a
    session of one outer iteration whose readings are dropped, then one
    sub-window read over the program's own outer spans, whose count is the
    outer iterations its solves ran, on every rank of a world; a follower's
    window is its own, not rank 0's profiler start and trace export."""
    root = tiny_root(tmp_path)
    cell = spec.load(f"tiny-{workload}", root)
    mix = Mix.read(cell.traffic)
    monkeypatch.setattr(harness, "PROFILE_S", 0.0)
    monkeypatch.setattr(harness, "SYNC_S", 0.0)
    from repro_torch.core import spans as program_spans
    from repro_torch.kernels import _build

    sessions, traces = [], []
    profiled, read_trace = profile.profiled, profile.read_trace

    def counted(work):
        ran = []
        out = profiled(lambda: ran.append(work()) or ran[-1])
        sessions.append((ran[0], out))
        return out

    def read(events):
        traces.append(read_trace(events))
        return traces[-1]
    monkeypatch.setattr(profile, "profiled", counted)
    monkeypatch.setattr(profile, "read_trace", read)

    def count_syncs(work):
        # the sync sub-window has the work sink and no span recorder
        assert len(_build.WORK_SINKS) == 1 and not program_spans.counting()
        return (lambda o: (o + 2, o))(work())
    monkeypatch.setattr(profile, "count_syncs", count_syncs)
    job = wd.Job(cell, root, 11, None, None, "cpu", 1)
    world = wd.World(job) if wd.ranks(cell) else None
    try:
        prob, inputs = job.problem(torch.device("cpu"), world.group if world else None)
        program = harness.Program(prob, inputs, world)
        got = harness._traced(program, mix, 1.0, 0)
        # syncs over one whole solve, as the window runs it
        whole = program.run(0, mix.max_outer, torch.device("cpu"))
        if world is not None:
            world.close()
    finally:
        if world is not None:
            world.kill()
    steady = 2 * harness.PROFILE_OUTER
    assert [ran for ran, _ in sessions] == [1, steady]
    assert got is sessions[1][1]
    # rank 0's outers are its trace's spans, as many as its solves ran
    assert [t["outers"] for t in traces] == [1, steady] and got["outers"] == steady
    assert 0 < got["window_s"] and got["busy_s"] == 0 and got["kernel_count"] == 0
    assert whole.converged and got["sync_outers"] == whole.outer
    assert got["syncs"] == whole.outer + 2
    assert sorted(program._built) == [1, steady, mix.max_outer]
    assert got["kernel_flops"] >= 0 and got["kernel_bytes"] >= 0
    assert _build.WORK_SINKS == []
    if world is None:
        assert "ranks" not in got and got["window_s"] == traces[1]["window_s"]
        return
    ranks = got["ranks"]
    assert len(ranks) == cell.chips and ranks[0]["window_s"] == traces[1]["window_s"]
    for r, reading in enumerate(ranks):
        # each follower read its own outer spans (None where it found none)
        assert reading["outers"] == steady, (r, reading)
        assert 0.5 < reading["window_s"] / ranks[0]["window_s"] < 2.0, ranks
    assert got["window_s"] == pytest.approx(sum(r["window_s"] for r in ranks) / len(ranks))


def test_outer_spans_that_miss_the_loops_iterations_fail_the_run():
    from repro_torch.core import spans as program_spans

    def work(ran: int, said: int):
        def go():
            for _ in range(ran):
                with program_spans.span("shard.outer"):
                    torch.ones(4).sum()
            return said
        return go
    assert profile.profiled(work(3, 3))["outers"] == 3
    with pytest.raises(RuntimeError, match="3 'shard.outer' spans where the work ran 4"):
        profile.profiled(work(3, 4))


class _World:
    """Followers that answer ``untrace`` with the given readings."""

    def __init__(self, readings):
        self.readings, self.peaks = readings, []

    def send(self, cmd, arg=None):
        self.cmd = cmd

    def answers(self):
        return self.readings if self.cmd == "untrace" else [None] * len(self.readings)


@pytest.mark.parametrize("follower_outers,ok", [(3, True), (None, True), (2, False)])
def test_a_worlds_readings_are_the_means_of_each_ranks_own(follower_outers, ok):
    from repro_torch.core import spans as program_spans

    def work():
        for _ in range(3):
            with program_spans.span("shard.outer"):
                torch.ones(4).sum()
        return 3
    follower = {"outers": follower_outers, "window_s": 0.5, "busy_s": 0.25,
                "kernel_count": 30, "kernel_s": 0.2}
    program = harness.Program(None, None, _World([follower]))
    if not ok:
        with pytest.raises(RuntimeError, match="rank 1's trace holds 2 outer spans"):
            program.profiled(work)
        return
    got = program.profiled(work)
    mine = got["ranks"][0]
    assert got["ranks"][1] == follower and mine["outers"] == 3
    assert got["window_s"] == pytest.approx((mine["window_s"] + 0.5) / 2)
    assert got["busy_s"] == pytest.approx(0.25 / 2)
    assert got["kernel_count"] == 15


@pytest.mark.parametrize("workload", cells())
def test_a_traced_runs_window_records_the_programs_spans(tmp_path, monkeypatch, workload):
    root = tiny_root(tmp_path)
    cell = spec.load(f"tiny-{workload}", root)
    monkeypatch.setattr(harness, "PROFILE_S", 0.0)
    monkeypatch.setattr(harness, "SYNC_S", 0.0)
    monkeypatch.setattr(profile, "profiled", lambda work: _linear(work()))
    from repro_torch.core import spans as program_spans

    def count_syncs(work):
        assert not program_spans.counting()   # the recorder is the window's alone
        return (lambda o: (o + 2, o))(work())
    monkeypatch.setattr(profile, "count_syncs", count_syncs)
    run = harness.run_cell(cell, 2 ** 31 + 17, 1.5, True, "cpu", time.perf_counter(), root=root)
    assert harness.passes(run.checks), run.checks
    spans, outers = run.traced["span_totals"], sum(s.outer for s in run.solves)
    # the window's solves, each detection's certification outside every span
    assert spans["shard.solve"]["count"] == len(run.solves) > 1
    assert any(s.converged for s in run.solves)
    assert spans["shard.outer"]["count"] == outers
    assert run.traced["counts"]["host_syncs"] == spans["shard.sync"]["count"] + 2 * len(run.solves)
    per = harness.per_layer(cell, run, "cpu", root)
    assert per["sync_wait_ms_per_outer"] > 0
    assert per["dispatch_ms_per_outer"] + per["sync_wait_ms_per_outer"] == pytest.approx(
        1e3 * spans["shard.outer"]["seconds"] / outers)
    # the outer iterations hold all but the solves' starts, results and draws
    assert 1e3 * spans["shard.outer"]["seconds"] / outers <= 1e3 * run.window_s / outers


def test_syncs_are_counted_without_the_modes_notice(monkeypatch):
    # torch warns once, on switching the mode on, that the mode is a prototype
    # "that does not yet detect all synchronizing operations": no sync
    noticed = []

    def set_mode(mode):
        if not noticed:
            noticed.append(mode)
            warnings.warn("Synchronization debug mode is a prototype feature and does not "
                          "yet detect all synchronizing operations")
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def work():
        for _ in range(5):   # five host reads of a device value, over two outer iterations
            warnings.warn("called a synchronizing CUDA operation")
        return 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert profile.count_syncs(work) == (5, 2)
    assert noticed == ["warn"]


class _Stub:
    """A program whose solve ``i`` returns at once, converged where ``i`` is
    even, with ``i % 5 + 1`` outer iterations and a one-element state."""

    follower_peaks: list = []

    def run(self, index, max_outer, device):
        return harness.Solve(index, max_outer, index % 5 + 1, index % 2 == 0, False, 0.0,
                             torch.zeros(1), torch.zeros(1))


def test_the_window_certifies_each_detection_with_its_clock_stopped():
    mix = Mix.read(json.loads((spec.ROOT / "perfbench/traffic/pfait-k4-inner4.json").read_text()))
    seen = []

    def certify(s):
        # the state is there to be read; the clock stands meanwhile
        assert s.x is not None and s.converged
        seen.append(s.index)
        time.sleep(0.01)
        return s.index / 100

    t0 = time.perf_counter()
    solves, window_s, _ = harness._window(_Stub(), mix, 0.05, 1e-3, 0, torch.device("cpu"),
                                          keep_all=False, certify=certify)
    detections = [s for s in solves if s.converged]
    assert len(detections) > 3 and seen == [s.index for s in detections]
    assert all(s.r_over_eps == s.index / 100 for s in detections)
    assert all(s.r_over_eps is None for s in solves if not s.converged)
    assert 0.05 <= window_s < time.perf_counter() - t0 - 0.01 * len(detections) + 1e-3
    # only the longest solve's state is held for the check
    longest = max(solves, key=lambda s: s.outer)
    assert all((s.x is not None) == (s is longest) for s in solves)


@pytest.mark.parametrize("left,rate,cap", [(51.0, 0.2, 255), (0.01, 0.2, 1), (51.0, 1e-4, 20000),
                                           (0.5, 0.25, 2)])
def test_a_solve_is_capped_at_the_outer_iterations_left(left, rate, cap):
    mix = Mix.read(json.loads((spec.ROOT / "perfbench/traffic/pfait-k4-inner4.json").read_text()))
    assert harness._cap(mix, left, rate) == cap


@pytest.mark.parametrize("workload", cells())
def test_set_up_stages_are_timed_in_order(tmp_path, workload):
    root = tiny_root(tmp_path)
    cell = spec.load(f"tiny-{workload}", root)
    t0 = time.perf_counter()
    run = harness.run_cell(cell, 2 ** 31 + 3, 0.2, False, "cpu", t0, root=root)
    world = ["the world's ranks"] if wd.ranks(cell) else []
    assert list(run.setup_stages) == ["process and imports", *world, "CUDA context",
                                      "first warm-up solve", "second warm-up solve",
                                      "the window's first runtime"]
    assert all(v >= 0 for v in run.setup_stages.values())
    assert sum(run.setup_stages.values()) <= run.setup_s + 1e-3
    assert harness.passes(run.checks), run.checks


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    reader = spec.load_module(spec.ROOT / "perfbench" / "metrics" / f"{metric}.py")
    cell = spec.load(cells()[0])
    empty = dict(outers=0, window_s=0.0, busy_s=0.0, kernel_count=0, kernel_s=0.0, syncs=0,
                 sync_outers=0, outer_s=0.0)
    for kind in ("NVIDIA H100 80GB HBM3", "a card with no peaks in the table"):
        ctx = SimpleNamespace(config=cell.config, mix=Mix.read(cell.traffic), device_kind=kind,
                              **empty)
        assert reader.read(ctx) is None


def test_device_time_past_the_window_annotation_still_counts():
    # the device's clock a little ahead of the host's: the last kernel
    # seems to start after the annotation ends
    ev = [{"ph": "X", "cat": "user_annotation", "name": profile.WINDOW, "ts": 0, "dur": 100,
           "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "cat", "ts": 101, "dur": 9}]
    got = profile.read_trace(ev)
    assert got["kernel_count"] == 2 and got["kernel_s"] == pytest.approx(39e-6)
    assert got["window_s"] == pytest.approx(110e-6) and got["busy_s"] == pytest.approx(39e-6)
