"""The port's checkpointer against the JAX package's
(``checkpoint/checkpointer.py``): JAX's ``tests/test_elastic_restart.py``
checkpoint cases mirrored — the type round trip through unsigned views
(bf16, f8), a restore that changes the shard count, an async failure
re-raised from ``wait`` and from the next ``save``, malformed directories
ignored by discovery and GC — and the two packages reading each other's
checkpoints with equal arrays and equal manifests."""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer, _parse_step
from repro_torch.runtime.elastic import remesh, reshard


def _state():
    return {
        "bf16": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
        "fp8": torch.linspace(-2, 2, 8).to(torch.float8_e4m3fn),
        "f32": torch.ones((3,), dtype=torch.float32),
        "nest": [torch.arange(4, dtype=torch.int64), (torch.zeros(2, dtype=torch.float64),)],
    }


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def test_checkpoint_view_dtype_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _state()
    ck.save(state, step=1, blocking=True)
    out, step = ck.restore(like=state, device="cpu")
    assert step == 1
    for k in ("bf16", "fp8", "f32"):
        assert out[k].dtype == state[k].dtype
        assert torch.equal(out[k].view(torch.uint8), state[k].view(torch.uint8))
    assert torch.equal(out["nest"][0], state["nest"][0])
    assert isinstance(out["nest"][1], tuple) and torch.equal(out["nest"][1][0],
                                                             state["nest"][1][0])


def test_checkpoint_topology_changing_restore(tmp_path):
    """Saved from one shard count's layout, restored for another: the
    checkpoint holds host data only, and ``reshard`` places it."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(12.0).reshape(12, 1)
    ck.save({"x": x}, step=3, blocking=True)
    out, step = ck.restore(like={"x": x}, device="cpu")
    assert step == 3 and torch.equal(out["x"], x)
    for shards in (4, 3, 2):
        placed = reshard(out, {"x": ("model", None)}, remesh(shards, model_axis=shards),
                         device="cpu")
        assert torch.equal(placed["x"], x)
    with pytest.raises(ValueError, match="does not divide"):
        reshard(out, {"x": ("model", None)}, remesh(5, model_axis=5), device="cpu")


def test_async_save_failure_raises_from_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr("repro_torch.checkpoint.checkpointer.np.save", boom)
    ck.save({"x": torch.ones(3)}, step=1)  # async: failure lands on the thread
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()
    # the error is consumed: a later save/wait cycle works again
    monkeypatch.undo()
    ck.save({"x": torch.ones(3)}, step=2, blocking=True)
    assert ck.latest_step() == 2


def test_async_save_failure_raises_from_next_save(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    monkeypatch.setattr("repro_torch.checkpoint.checkpointer.np.save",
                        lambda *a, **kw: (_ for _ in ()).throw(OSError("x")))
    ck.save({"x": torch.ones(3)}, step=1)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.save({"x": torch.ones(3)}, step=2)


@pytest.mark.parametrize("name", ["step_000010", "step_abc", "step_", "notastep",
                                  "step_00002.tmp"])
def test_parse_step_matches_jax(name):
    from repro.checkpoint.checkpointer import _parse_step as jparse

    assert _parse_step(name) == jparse(name)


def test_malformed_step_dirs_are_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=1)
    for name in ("step_abc", "notastep", "step_00002.tmp"):
        os.makedirs(tmp_path / name)
    (tmp_path / "README").write_text("stray file")
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(device="cpu")
    ck.save({"x": torch.ones(2)}, step=1, blocking=True)
    ck.save({"x": torch.ones(2)}, step=2, blocking=True)  # triggers _gc
    assert ck.latest_step() == 2
    assert not (tmp_path / "step_000001").exists()
    # foreign entries survive GC untouched
    assert (tmp_path / "step_abc").exists()
    assert (tmp_path / "README").exists()


def test_uncommitted_step_is_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save({"x": torch.ones(2)}, step=4, blocking=True)
    os.remove(tmp_path / "step_000004" / "_COMMITTED")
    assert ck.latest_step() is None


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path))
    ck.save(state, step=7)   # async, joined before JAX reads it
    ck.wait()
    like = {"bf16": 0, "fp8": 0, "f32": 0, "nest": [0, (0,)]}
    out, step = JCheckpointer(str(tmp_path)).restore(like=like)
    assert step == 7
    for k in ("bf16", "fp8", "f32"):
        assert np.asarray(out[k]).dtype == _as_np(state[k]).dtype
        assert np.asarray(out[k]).tobytes() == _as_np(state[k]).tobytes()
    assert np.asarray(out["nest"][0]).tobytes() == state["nest"][0].numpy().tobytes()
    jax_dir = tmp_path / "jax"
    JCheckpointer(str(jax_dir)).save({k: _as_np(v) for k, v in state.items() if k != "nest"},
                                     step=7, blocking=True)
    want = json.loads((jax_dir / "step_000007" / "manifest.json").read_text())
    Checkpointer(str(tmp_path / "port")).save({k: v for k, v in state.items() if k != "nest"},
                                              step=7, blocking=True)
    got = json.loads((tmp_path / "port" / "step_000007" / "manifest.json").read_text())
    assert got == want


def test_jax_checkpoint_restores_in_port(tmp_path):
    state = {"bf16": np.arange(6, dtype=ml_dtypes.bfloat16).reshape(2, 3),
             "fp8": np.linspace(-2, 2, 8).astype(ml_dtypes.float8_e4m3fn),
             "x": np.linspace(0, 1, 5),
             # 0-d leaves (a train state's step, a monitor's counters)
             "s0": np.asarray(3, np.int32), "b0": np.asarray(1.5, ml_dtypes.bfloat16)}
    JCheckpointer(str(tmp_path)).save(state, step=9, blocking=True)
    out, step = Checkpointer(str(tmp_path)).restore(like={k: 0 for k in state},
                                                    device="cpu")
    assert step == 9
    assert out["bf16"].dtype == torch.bfloat16 and out["fp8"].dtype == torch.float8_e4m3fn
    for k, v in state.items():
        assert _as_np(out[k]).dtype == v.dtype and tuple(out[k].shape) == v.shape
        assert _as_np(out[k]).tobytes() == v.tobytes()
    leaves, _ = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert [tuple(t.shape) for t in leaves] == [(), (2, 3), (8,), (), (5,)]


def test_save_snapshots_cpu_tensors_before_returning(tmp_path, monkeypatch):
    """A training loop updates its parameters in place right after an
    async ``save`` returns: the checkpoint holds the values at the call."""
    import threading

    from repro_torch.checkpoint import checkpointer as tck

    may_write = threading.Event()
    np_save = tck.np.save

    def held_save(*args, **kw):
        assert may_write.wait(timeout=30)
        return np_save(*args, **kw)

    monkeypatch.setattr(tck.np, "save", held_save)
    ck = Checkpointer(str(tmp_path))
    state = {"w": torch.ones(4), "h": torch.ones(2, dtype=torch.bfloat16)}
    ck.save(state, step=1)
    for t in state.values():
        t.add_(1.0)                  # in place, while the write is pending
    may_write.set()
    ck.wait()
    out, _ = ck.restore(like=state, device="cpu")
    assert torch.equal(out["w"], torch.ones(4))
    assert torch.equal(out["h"], torch.ones(2, dtype=torch.bfloat16))
