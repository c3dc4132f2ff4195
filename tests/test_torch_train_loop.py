"""The port's training driver (``launch/train.py``) on the CPU: the
behaviours JAX's ``tests/test_system.py`` and ``tests/test_train_loop.py``
hold the JAX driver to, on the port's own runs (the packages draw weights
differently, so the loss series differ; the rules they are held to do
not): the loss decreases; sync and PFAIT fire at the target, PFAIT exactly
K steps after sync; a checkpointed run resumes where it stopped; PFAIT
detects at the tightened ε̃ / margin; the straggler policy sees step
durations; the fire step equals a host replay of the detection rule on
the loss series the driver read; the monitor ring survives a checkpoint
bitwise.  And the driver refuses to fall back to the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.core import detection
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch.train import train
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, constant_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-1.5b"


def _train(**kw):
    kw.setdefault("log_every", 1000)
    return train(ARCH, use_reduced=True, device="cpu", **kw)


def _replay_fire_step(losses, eps, K, mode, m=4):
    """Host replay of ``core/detection.step`` on a recorded metric series:
    the step the monitor must fire at (the visible value is K-stale)."""
    persist = 0
    for k in range(len(losses)):
        vis = losses[k - K] if k >= K else float("inf")
        below = vis < eps
        if mode in ("sync", "pfait"):
            if below:
                return k
        else:   # nfais2, no external verifier: stale-value fallback
            persist = persist + 1 if below else 0
            if persist >= m:
                return k
    return None


def test_train_loss_decreases():
    out = _train(steps=25, batch=4, seq=64)
    assert len(out["losses"]) >= 20
    assert out["losses"][-1] < out["losses"][0]
    # random-init logits are small: the first loss is ≈ ln(vocab)
    assert out["losses"][0] == pytest.approx(np.log(256), abs=0.1)
    assert out["steps_run"] == 25 and out["stop_step"] is None


@pytest.mark.parametrize("mode", ["sync", "pfait"])
def test_train_until_target_loss(mode):
    out = _train(steps=120, batch=4, seq=64, target_loss=3.8, monitor_mode=mode,
                 staleness=3, margin=1.0)
    assert out["stop_step"] is not None, f"{mode} never fired"
    assert min(out["losses"]) < 3.8
    assert out["steps_run"] == out["stop_step"] + 2   # the loop stopped at once


def test_pfait_fires_later_than_sync_by_staleness():
    common = dict(steps=150, batch=4, seq=64, target_loss=3.8, margin=1.0, seed=1)
    sync = _train(monitor_mode="sync", **common)
    pfait = _train(monitor_mode="pfait", staleness=4, **common)
    assert sync["stop_step"] is not None and pfait["stop_step"] is not None
    # same data / model / seed → PFAIT fires exactly K steps after sync
    assert pfait["stop_step"] == sync["stop_step"] + 4
    n = len(sync["losses"])   # one trajectory, read later
    np.testing.assert_allclose(pfait["losses"][:n], sync["losses"], rtol=1e-6)


def test_checkpoint_restart_continues(tmp_path):
    d = str(tmp_path / "ck")
    out1 = _train(steps=30, batch=4, seq=64, ckpt_dir=d, ckpt_every=10, seed=2)
    assert out1["steps_run"] == 30
    assert Checkpointer(d).latest_step() == 21   # saved after step 20, tagged 21
    # resume: restores at step 21 and continues to 40
    out2 = _train(steps=40, batch=4, seq=64, ckpt_dir=d, ckpt_every=10, seed=2)
    assert out2["steps_run"] == 40
    assert len(out2["losses"]) == 40 - 21 - 1


@pytest.mark.parametrize("mode", ["sync", "pfait", "nfais2", "nfais5"])
def test_train_all_monitor_modes_run(mode):
    out = _train(steps=12, batch=2, seq=32, target_loss=0.001, monitor_mode=mode)
    assert out["steps_run"] == 12 and out["stop_step"] is None   # target unreachable


@pytest.mark.parametrize("metric", ["update_norm", "grad_norm"])
def test_train_monitors_other_metrics(metric):
    """A target above every value of the metric: the monitor fires K steps
    after the first check (its ring is primed with +inf)."""
    out = _train(steps=12, batch=2, seq=32, target_loss=1e6, monitor_mode="pfait",
                 staleness=2, margin=1.0, monitor_metric=metric)
    assert out["stop_step"] == 2


def test_pfait_monitor_uses_tightened_threshold():
    """``train`` routes through ``detection.for_mode``: PFAIT detects at
    ε = ε̃ / margin, not at ε̃ itself."""
    out = _train(steps=8, batch=2, seq=32, target_loss=2.0, monitor_mode="pfait",
                 staleness=2)
    mon = out["monitor"]
    assert mon.eps == pytest.approx(mon.eps_tilde / 10.0)
    assert mon.eps == pytest.approx(2.0 / 10.0)
    out = _train(steps=2, batch=2, seq=32, target_loss=2.0, monitor_mode="pfait",
                 margin=100.0)
    assert out["monitor"].eps == pytest.approx(2.0 / 100.0)
    out = _train(steps=2, batch=2, seq=32, target_loss=2.0, monitor_mode="sync")
    assert out["monitor"].eps == pytest.approx(2.0) and out["monitor"].staleness == 0


def test_straggler_records_nontrivial_step_durations():
    """Durations are taken where the previous step's loss is read, so they
    span a step's work, not the time to issue it."""
    out = _train(steps=10, batch=2, seq=32)
    recorded = out["stragglers"]._hist.get(0, [])
    assert len(recorded) == 9
    assert float(np.median(recorded)) > 1e-3
    assert all(d > 0 for d in recorded)


@pytest.mark.parametrize("mode,staleness", [("sync", 0), ("pfait", 3), ("nfais2", 3)])
def test_monitor_fires_at_oracle_consistent_step(mode, staleness):
    """The fire step equals a host replay of the detection rule on the
    recorded loss series (margin 1, so every mode targets the same ε)."""
    out = _train(steps=120, batch=4, seq=64, target_loss=3.8, monitor_mode=mode,
                 staleness=staleness, margin=1.0)
    assert out["stop_step"] is not None, f"{mode} never fired"
    expected = _replay_fire_step(out["losses"], 3.8, staleness, mode,
                                 m=out["monitor"].persistence)
    assert out["stop_step"] == expected


def test_checkpoint_restores_monitor_ring_bitwise(tmp_path):
    """The PFAIT ring is part of the training state: a restore (the path
    ``train`` takes) resumes the stale-reduction pipeline bitwise."""
    cfg = reduced(get_arch(ARCH))
    model = Model(cfg, device="cpu")
    opt = AdamW(constant_schedule(1e-3))
    monitor = detection.for_mode("pfait", eps_tilde=3.8, staleness=3, persistence=4, ord=1.0)
    step_fn, _ = model.make_train_step(opt, monitor=monitor)
    state = model.init_train_state(torch.Generator().manual_seed(0), opt, monitor=monitor)
    dc = DataConfig(seed=0, vocab_size=cfg.vocab_size)
    for step in range(6):
        batch = {k: torch.from_numpy(v) for k, v in synth_batch(dc, step, 2, 32).items()}
        state, _ = step_fn(state, batch)
    assert int(torch.isfinite(state.monitor.ring).sum()) >= monitor.ring_len   # primed

    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(interop.train_state_tree(state), 6)
    ckpt.wait()
    tree, step = ckpt.restore(like=interop.train_state_tree(state), device="cpu")
    restored = interop.train_state_from(tree, model)
    assert step == 6
    for leaf, ref in zip(restored.monitor, state.monitor):
        assert leaf.dtype == ref.dtype and leaf.shape == ref.shape
        assert torch.equal(leaf, ref)
    assert torch.equal(restored.step, state.step)
    for name, p in restored.params.named_parameters():
        assert torch.equal(p, dict(state.params.named_parameters())[name])
        assert torch.equal(restored.opt.m[name], state.opt.m[name])


def test_train_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(ARCH, steps=2, batch=1, seq=8)
    assert train(ARCH, steps=2, batch=1, seq=8, device="cpu",
                 log_every=1000)["steps_run"] == 2


def test_train_cli_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
                          "--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
                          "--target-loss", "4.0", "--device", "cpu"],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] step     0 loss" in out.stdout
    assert "[train] done: 4 steps" in out.stdout
