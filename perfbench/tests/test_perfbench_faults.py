"""``correct`` comes out false for the control and for each fault the
cells can have, planted underneath the program's timed path, on the CPU
at tiny sizes (the run skips only the look for a card)."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.tests._tiny import cells, tiny_root
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


def _wrap_loop(monkeypatch, change):
    make = sr._make_loop

    def patched(cfg, transport, mesh_shape=None):
        loop = make(cfg, transport, mesh_shape)
        return lambda prob, xs: loop(change(prob), xs)
    monkeypatch.setattr(sr, "_make_loop", patched)


def unchanged_state(monkeypatch):
    def change(prob):
        return prob._replace(sweep=lambda i, x, g: x, sweep_contribs=None,
                             sweep_contrib=lambda i, x, g: (x, prob.sweep_contrib(i, x, g)[1]))
    _wrap_loop(monkeypatch, change)


def half_the_shards(monkeypatch):
    def patched(self, lanes, ord):
        keep = [lanes[i] for i in sorted(lanes)[:max(1, len(lanes) // 2)]]
        return tp.Pending.done(tp._preduce(torch.stack(keep), ord) * (len(lanes) / len(keep)))
    monkeypatch.setattr(tp.StackedTransport, "reduce", patched)


def no_exchange(monkeypatch):
    def change(prob):
        first = []

        def exchange(xs):
            if not first:
                first.append(prob.exchange(xs))
            return first[0]
        return prob._replace(exchange=exchange)
    _wrap_loop(monkeypatch, change)


def altered_answer(monkeypatch):
    result = sr._result

    def patched(*args, **kw):
        r = result(*args, **kw)
        return r._replace(x=r.x * (1 + 1e-6))
    monkeypatch.setattr(sr, "_result", patched)


def test_sound_runs_pass(root):
    for w in cells():
        ok, checks = _run(root, w)
        assert ok, (w, checks)


@pytest.mark.parametrize("workload", cells())
def test_the_control_in_float32_fails(root, workload):
    ok, checks = _run(root, workload, control=torch.float32)
    assert not ok, checks


@pytest.mark.parametrize("fault", [unchanged_state, half_the_shards, no_exchange, altered_answer])
@pytest.mark.parametrize("workload", cells())
def test_a_planted_fault_fails(root, workload, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks = _run(root, workload)
    assert not ok, checks
