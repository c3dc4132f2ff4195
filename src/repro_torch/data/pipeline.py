"""Synthetic-token data pipeline (port of ``data/pipeline.py``):
deterministic, shardable, restartable.

``synth_batch`` is the JAX package's numpy draw, copied: batches are keyed
by ``(seed, step, shard)``, so both packages see bitwise the same tokens
and a restarted job resumes exactly where its checkpoint left off.  A
background thread (``Prefetcher``) keeps batches ahead of the device;
``device_batches`` puts each one on the device from pinned host memory
with a non-blocking copy, issued on the producer thread, so the host
never waits for the copy and the step that follows is queued behind it.
Given a mesh, each rank keeps its block of the global batch's rows over
the data-parallel axes (JAX's ``device_put`` under ``P(dp)``).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    frontend_dim: int = 0       # >0 → embedding inputs (modality stub)
    zipf_a: float = 1.2         # skewed token distribution (realistic-ish)


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    # splitmix-style mix so (seed, step, shard) streams are independent
    key = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + shard) % (2**63)
    return np.random.default_rng(key)


def synth_batch(cfg: DataConfig, step: int, batch: int, seq: int,
                shard: int = 0) -> Dict[str, np.ndarray]:
    """One host-shard of the global batch for ``step``."""
    rng = _rng_for(cfg.seed, step, shard)
    if cfg.frontend_dim > 0:
        inputs = rng.standard_normal((batch, seq, cfg.frontend_dim)).astype(np.float32)
        # embedding-frontend targets are synthetic classes: independent
        # draws, no next-token shift (rolling random labels is a no-op)
        labels = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    else:
        z = rng.zipf(cfg.zipf_a, size=(batch, seq)).astype(np.int64)
        inputs = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
        labels = np.roll(inputs, -1, axis=-1).astype(np.int32)
        labels[:, -1] = -1   # wraparound position carries no target
    return {"inputs": inputs, "labels": labels}


class Prefetcher:
    """Double-buffered background batch producer (depth-1 lookahead)."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, self._make(step))
            except BaseException as e:   # noqa: BLE001 — surfaced by __next__
                self._error = e
                self._stop.set()
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError(
                        "Prefetcher producer thread died") from self._error
                if self._stop.is_set():
                    raise StopIteration   # closed and drained
                # producer alive and queue momentarily empty: keep waiting

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def device_batches(model_cfg: ModelConfig, shape: ShapeConfig, mesh=None, seed: int = 0,
                   start_step: int = 0, device: DeviceLike = None) -> Prefetcher:
    """Iterator of (step, batch on ``device``) for a train shape; the
    device is the mesh's or the card unless the caller asks for another.
    On a mesh the batch is this rank's rows over the data-parallel axes."""
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    dc = DataConfig(
        seed=seed,
        vocab_size=model_cfg.vocab_size,
        frontend_dim=model_cfg.frontend_dim if model_cfg.frontend else 0,
    )
    rows = slice(None)
    if mesh is not None:
        dp = tuple(a for a in mesh.axis_names if a != "model")
        k = mesh.size(dp)
        if shape.global_batch % k:
            raise ValueError(f"global batch {shape.global_batch} does not split over the "
                             f"{k} data-parallel ranks of {mesh.shape}")
        n = shape.global_batch // k
        rows = slice(mesh.index(dp) * n, (mesh.index(dp) + 1) * n)

    def make(step: int):
        host = {k: v[rows] for k, v in
                synth_batch(dc, step, shape.global_batch, shape.seq_len).items()}
        if dev.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in host.items()}
        # the caching host allocator keeps a pinned buffer until the copy
        # that reads it has run
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
            dev, non_blocking=True) for k, v in host.items()}

    return Prefetcher(make, start_step=start_step)
