"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither ``jax`` nor any module of ``repro``; entry
points default to the card and refuse to fall back to the CPU."""
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import _device
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.core import detection
from repro_torch.launch import mesh, serve
from repro_torch.models.model import Model
from repro_torch.runtime import api, shard_runtime
from repro_torch.solvers import fixed_point
from repro_torch.solvers.convdiff import Stencil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = textwrap.dedent("""
    import importlib, pkgutil, sys
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # module level only: main() is not run
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    assert not leaked, leaked
    assert len(names) >= 81, names
    assert "repro_torch.solvers.partition" in names, names
    assert "repro_torch.launch.serve" in names, names
    assert "repro_torch.runtime.api" in names, names
    assert "repro_torch.solvers.pagerank" in names, names
    assert "repro_torch.launch.mesh" in names, names
    assert "repro_torch.launch.worlds" in names, names
    assert "repro_torch.runtime.transport" in names, names
    assert "repro_torch.solvers.mlfixed" in names, names
    for name in ("runtime.train_async", "runtime.elastic", "runtime.fault_tolerance",
                 "checkpoint.checkpointer", "optim.adamw", "optim.grad_compression",
                 "data.pipeline", "launch.train", "models.ssm", "models.moe",
                 "core.async_engine", "core.protocols", "core.scenarios", "core.reliability",
                 "sim", "sim.replay", "sim.calibrate", "core.compat", "models.collectives",
                 "models.tp_reduce", "launch.dryrun", "launch.hlo_analysis"):
        assert "repro_torch." + name in names, names
    print("ISOLATED", len(names))
""")


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), REPO])
    out = subprocess.run([sys.executable, "-c", _PROGRAM], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.resolve_device()
    assert _device.resolve_device("cpu") == torch.device("cpu")
    st = Stencil.for_contraction(4, 1.0, (1.0, 1.0, 1.0), 0.9)
    cfg = fixed_point.SolverConfig(stencil=st, monitor=detection.MonitorConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fixed_point.solve_single(cfg, np.ones((4, 4, 4)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fixed_point.make_sharded_solver(cfg, (2, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_shard_group((2,), "gloo", rank=0)
    rcfg = shard_runtime.ShardRuntimeConfig(monitor=detection.MonitorConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_runtime.make_convdiff_runtime(rcfg, 2, st, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_runtime.make_pagerank_runtime(rcfg, 2, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.run_shard("pagerank", api.RuntimeConfig(monitor=detection.MonitorConfig()), 2, 4,
                      np.full(4, 0.25), np.eye(4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve("qwen2-1.5b", batch=1, prompt_len=4, max_new=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_detection([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.DetectionService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detection.init_lanes(2, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detection.batched_monitor("pfait", np.ones((1, 4), np.float32), [1e-3], [0], [1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detection.batched_monitor("pfait", torch.ones(1, 4), [1e-3], [0], [1])
    assert detection.init_lanes(2, 3, "cpu").step.device.type == "cpu"
    for arch in ("qwen2-1.5b", "mamba2-130m", "musicgen-medium"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Model(reduced(get_arch(arch)))
        assert Model(reduced(get_arch(arch)), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve("hymba-1.5b", batch=1, prompt_len=4, max_new=2)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result (with or without a card)."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_train_and_elastic_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.runtime import elastic, train_async
    from repro_torch.solvers.mlfixed import MLFixedPointProblem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = MLFixedPointProblem(n=8, p=1, m_rows=16, seed=3)
    mon = detection.MonitorConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_async.safe_gamma(prob, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_async.make_train_runtime(prob, train_async.TrainAsyncConfig(monitor=mon,
                                                                          gamma=0.1), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.run_train(prob, api.RuntimeConfig(monitor=mon, gamma=0.1), 1, np.zeros((1, 8)),
                      prob.A, prob.y)
    st = Stencil.for_contraction(4, 1.0, (1.0, 1.0, 1.0), 0.9)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.run_elastic("convdiff", api.RuntimeConfig(monitor=mon), 4, np.zeros((4, 4, 4)),
                        np.ones((4, 4, 4)), elastic.FaultPlan(), str(tmp_path / "e"),
                        stencil=st, slots=1)
    ck = Checkpointer(str(tmp_path / "c"))
    ck.save({"x": torch.ones(2)}, step=1, blocking=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ck.restore()
    assert ck.restore(device="cpu")[0][0].device.type == "cpu"


def test_event_methods_default_to_cuda(monkeypatch):
    """The problems' event-level methods put their blocks on the card unless
    asked for another device, and raise without one; the lane-only methods
    need no device."""
    from repro_torch.core import async_engine, protocols
    from repro_torch.core.trace import EngineTraceObserver
    from repro_torch.solvers.convdiff import ConvDiffProblem
    from repro_torch.solvers.mlfixed import MLFixedPointProblem
    from repro_torch.solvers.pagerank import PageRankProblem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = (lambda **kw: ConvDiffProblem(n=8, p=4, **kw),
              lambda **kw: PageRankProblem(n=64, p=4, **kw),
              lambda **kw: MLFixedPointProblem(n=8, p=4, m_rows=16, **kw))
    for make in makers:
        prob = make()
        assert prob.lane_x0() is not None   # no device needed for the lanes
        for call in (lambda: prob.init_local(0), lambda: prob.neighbors(0),
                     lambda: prob.interface(0, torch.zeros(1), 1),
                     lambda: prob.update_with_residual(0, torch.zeros(1), {})):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            async_engine.AsyncEngine(prob, async_engine.stable_platform(),
                                     protocols.PFAIT(1e-6, ord=prob.ord))
        cpu = make(device="cpu")
        assert cpu.init_local(0).device.type == "cpu"
        res = async_engine.AsyncEngine(
            cpu, dataclasses.replace(async_engine.stable_platform(), max_iters=5),
            protocols.PFAIT(1e-6, ord=cpu.ord), recorder=EngineTraceObserver(cpu.p)).run()
        assert res.k_max == 5
