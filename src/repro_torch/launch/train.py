"""End-to-end training driver (port of ``launch/train.py``).

The paper's technique at the driver level: the train step carries a
``MonitorState`` (the K-stale loss ring of ``core/detection.py``) and the
host reads the *previous* step's loss and ``converged`` flag, never the
current step's, so the loop never waits on a metric of the step it has
just issued, as the paper replaces the blocking residual reduction with
successive non-blocking ones.

Also wires the synthetic data (``data/pipeline.py``, pinned host memory,
non-blocking copies), checkpointing in the JAX package's tree layout with
restore (``checkpoint/``, ``interop.train_state_tree``) and straggler
timing (``runtime/fault_tolerance.py``).  Training runs on the card unless
the caller asks for the CPU.  Given a mesh (``launch.mesh.ModelMesh``,
every rank of the world calling ``train``) the model is sharded over it
with the default ``ParallelConfig()`` (dense FSDP over ``data``, as JAX's
``train`` runs) and each rank reads its rows of every batch.  A
checkpoint of a sharded state holds the global leaves, as JAX's does:
every rank gathers them and rank 0 writes; on restore every rank reads
the files and keeps its blocks.

Usage (CPU example run — reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --steps 200 --batch 8 --seq 128 --target-loss 4.0 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import interop
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeConfig, reduced as reduced_cfg
from repro_torch.configs.registry import get_arch
from repro_torch.core import detection
from repro_torch.data.pipeline import device_batches
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import StragglerPolicy


def train(
    arch: str,
    steps: int = 200,
    batch: int = 8,
    seq: int = 128,
    use_reduced: bool = True,
    target_loss: Optional[float] = None,
    monitor_mode: str = "pfait",
    staleness: int = 4,
    margin: float = 10.0,
    monitor_metric: str = "loss",
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    device: DeviceLike = None,
):
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduced_cfg(cfg)
    shape = ShapeConfig("custom", seq_len=seq, global_batch=batch, kind="train")
    model = Model(cfg, mesh=mesh, device=dev)
    writer = mesh is None or mesh.rank == 0   # the rank that writes checkpoints
    opt = AdamW(cosine_schedule(3e-3, max(steps // 20, 1), steps))
    # the shared ε̃/margin convention (core/detection.for_mode): PFAIT
    # detects at the *tightened* threshold ε = ε̃ / margin, every other
    # mode at ε̃ itself
    monitor = detection.for_mode(
        monitor_mode,
        eps_tilde=target_loss if target_loss is not None else 0.0,
        margin=margin,
        staleness=0 if monitor_mode == "sync" else staleness,
        persistence=4,
        ord=1.0,   # scalar metric: σ = identity
    )
    step_fn, _ = model.make_train_step(opt, monitor=monitor, monitor_metric=monitor_metric)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = model.init_train_state(gen, opt, monitor=monitor)
    if ckpt and ckpt.latest_step() is not None:
        # the global leaves go to the host on a mesh: each rank keeps its blocks
        tree, start_step = ckpt.restore(like=interop.train_state_tree(state),
                                        device="cpu" if mesh is not None else dev)
        state = interop.train_state_from(tree, model)
        print(f"[train] restored checkpoint at step {start_step}")

    data = device_batches(cfg, shape, mesh=mesh, seed=seed, start_step=start_step,
                          device=dev)
    stragglers = StragglerPolicy()
    pending_metrics = None  # the previous step's metrics, still on the device
    losses = []
    t0 = time.time()
    stop_step = None
    try:
        for step, batch_arrays in data:
            if step >= steps:
                break
            ts = time.time()
            state, metrics = step_fn(state, batch_arrays)
            # --- PFAIT-style non-blocking monitoring -------------------
            # only the previous step's values are read: the host never
            # waits on the step it has just issued
            if pending_metrics is not None:
                prev_step, prev, prev_ts = pending_metrics
                loss = float(prev["loss"])
                # the read above waited for step ``prev_step``: its
                # issue→completion wall time is the step duration the
                # straggler policy needs
                stragglers.record(0, time.time() - prev_ts)
                losses.append(loss)
                if prev_step % log_every == 0:
                    print(f"[train] step {prev_step:5d} loss {loss:.4f} "
                          f"gnorm {float(prev['grad_norm']):.3f}")
                if target_loss is not None and bool(prev["converged"]):
                    stop_step = prev_step
                    print(f"[train] monitor fired at step {prev_step} "
                          f"(mode={monitor_mode}, K={monitor.staleness})")
                    break
            pending_metrics = (step, metrics, ts)
            if ckpt and step > 0 and step % ckpt_every == 0:
                # tag = next data step: resume replays nothing, skips nothing
                tree = interop.train_state_tree(state, model, keep=writer)
                if writer:
                    ckpt.save(tree, step + 1)
    finally:
        data.close()
        if ckpt and writer:
            ckpt.wait()
    wall = time.time() - t0
    return {
        "state": state,
        "losses": losses,
        "steps_run": int(state.step),
        "stop_step": stop_step,
        "wall_s": wall,
        "stragglers": stragglers,
        "monitor": monitor,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--target-loss", type=float, default=None)
    ap.add_argument("--monitor", default="pfait", choices=["sync", "pfait", "nfais2", "nfais5"])
    ap.add_argument("--staleness", type=int, default=4)
    ap.add_argument("--margin", type=float, default=10.0,
                    help="PFAIT threshold margin: detect at eps = target/margin")
    ap.add_argument("--monitor-metric", default="loss",
                    choices=["loss", "update_norm", "grad_norm"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args()
    out = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        use_reduced=args.reduced, target_loss=args.target_loss,
        monitor_mode=args.monitor, staleness=args.staleness,
        margin=args.margin, monitor_metric=args.monitor_metric,
        ckpt_dir=args.ckpt_dir, seed=args.seed, device=args.device,
    )
    print(f"[train] done: {out['steps_run']} steps in {out['wall_s']:.1f}s; "
          f"final loss {out['losses'][-1] if out['losses'] else float('nan'):.4f}")


if __name__ == "__main__":
    main()
