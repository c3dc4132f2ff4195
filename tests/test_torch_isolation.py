"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads neither ``jax`` nor any module of ``repro``; entry
points default to the card and refuse to fall back to the CPU."""
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
    assert len(names) >= 52, names
    assert "repro_torch.solvers.partition" in names, names
    assert "repro_torch.launch.serve" in names, names
    assert "repro_torch.runtime.api" in names, names
    assert "repro_torch.solvers.pagerank" in names, names
    assert "repro_torch.launch.mesh" in names, names
    assert "repro_torch.launch.worlds" in names, names
    assert "repro_torch.runtime.transport" in names, names
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
        Model(reduced(get_arch("qwen2-1.5b")))
    assert Model(reduced(get_arch("qwen2-1.5b")), device="cpu").device.type == "cpu"


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script exits non-zero and prints no result (with or without a card)."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
