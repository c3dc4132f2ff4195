"""Async checkpointing with topology-free restore.

Layout per step (the JAX package's ``checkpoint/checkpointer.py``, file for
file, so a checkpoint written by either package restores in the other)::

    <dir>/step_000120/
        manifest.json     # step, leaf files, shapes/dtypes, tree structure
        leaf_00000.npy …  # one array per pytree leaf (host copy)
        _COMMITTED        # written last — partial checkpoints are ignored

A step is written into ``step_NNNNNN.tmp`` and renamed into place once
committed.  ``save`` copies every leaf to the host synchronously (the
producing stream is synchronised by the copy; a CPU tensor is copied too)
and serialises on a background thread, so the caller does not wait for the filesystem; a
failed write is re-raised from ``wait`` and from the next ``save``.
``restore`` places the leaves on a device: the checkpoint holds no layout,
so any shard count can resume from it.

A pytree is a tensor (or numpy array), or a dict, list or tuple of
pytrees; dict keys are taken in sorted order, as JAX flattens them.
Types numpy has no name for are stored as same-width unsigned views with
the logical type in the manifest: bf16 as ``uint16`` under ``"bfloat16"``,
the f8 types as ``uint8`` — the JAX package's encoding, with no
``ml_dtypes`` needed here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

# the logical types stored as unsigned views: (torch type, view width)
_VIEW_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16),
                "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
                "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}
_BY_TORCH = {t: name for name, (t, _) in _VIEW_DTYPES.items()}


def _encode(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array ``np.save`` writes, and its logical type.  A
    tensor is copied (a CPU tensor too), so an update the caller makes in
    place after ``save`` returns does not reach the checkpoint."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _BY_TORCH.get(t.dtype)
        if name is not None:
            width = _VIEW_DTYPES[name][1]
            return t.view(_SIGNED[width]).to("cpu", copy=True).numpy().view(width), name
        arr = t.to("cpu", copy=True).numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    # ``np.ascontiguousarray`` makes a 0-d array 1-d: the shape is restored
    if name in _VIEW_DTYPES:
        dtype, width = _VIEW_DTYPES[name]
        signed = torch.from_numpy(np.ascontiguousarray(arr).view(width).view(
            np.int16 if width is np.uint16 else np.uint8))
        return signed.view(dtype).reshape(arr.shape)
    return torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)


def _flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in JAX's order and the structure (``"*"`` for a leaf)."""
    if isinstance(tree, dict):
        leaves, spec = [], {}
        for k in sorted(tree):
            sub, spec[k] = _flatten(tree[k])
            leaves += sub
        return leaves, spec
    if isinstance(tree, (list, tuple)):
        leaves, spec = [], []
        for v in tree:
            sub, s = _flatten(v)
            leaves += sub
            spec.append(s)
        return leaves, (tuple(spec) if isinstance(tree, tuple) else spec)
    return [tree], "*"


def _unflatten(spec, leaves: List[Any]):
    it = iter(leaves)

    def build(s):
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            out = [build(v) for v in s]
            return tuple(out) if isinstance(s, tuple) else out
        return next(it)

    return build(spec)


def _spec_repr(spec) -> str:
    if isinstance(spec, dict):
        return "{" + ", ".join(f"{k!r}: {_spec_repr(v)}" for k, v in spec.items()) + "}"
    if isinstance(spec, tuple):
        inner = ", ".join(_spec_repr(v) for v in spec)
        return f"({inner},)" if len(spec) == 1 else f"({inner})"
    if isinstance(spec, list):
        return "[" + ", ".join(_spec_repr(v) for v in spec) + "]"
    return "*"


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:06d}")


def _parse_step(name: str) -> Optional[int]:
    """Step number of a ``step_NNNNNN`` directory name, or None for
    anything malformed (stray files, ``step_`` without digits, tmp dirs) —
    a foreign file in the checkpoint dir must not crash GC or discovery."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    suffix = name[len("step_"):]
    return int(suffix) if suffix.isdigit() else None


class Checkpointer:
    def __init__(self, base_dir: str, keep: int = 3):
        self.base = base_dir
        self.keep = keep
        os.makedirs(base_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, state: Any, step: int, blocking: bool = False) -> None:
        """Snapshot to the host, then serialise asynchronously (or now,
        with ``blocking``)."""
        self.wait()  # at most one in-flight save
        leaves, spec = _flatten(state)
        host = [_encode(leaf) for leaf in leaves]
        treedef_repr = f"PyTreeDef({_spec_repr(spec)})"

        def write():
            d = _step_dir(self.base, step)
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "n_leaves": len(host),
                        "treedef": treedef_repr, "leaves": []}
            for i, (arr, dtype_name) in enumerate(host):
                name = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, name), arr)
                manifest["leaves"].append(
                    {"file": name, "shape": list(arr.shape), "dtype": dtype_name})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)
            self._gc()

        if blocking:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as exc:  # noqa: BLE001 — re-raised by wait()
                    self._error = exc

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save; a failure on the background thread is
        re-raised here (or from the next ``save``, which waits first) —
        never silently reported as committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc = self._error
            self._error = None
            raise RuntimeError("async checkpoint save failed") from exc

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.base):
            step = _parse_step(name)
            d = os.path.join(self.base, name)
            if step is not None and os.path.exists(os.path.join(d, "_COMMITTED")):
                steps.append(step)
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None,
                device: DeviceLike = None) -> Tuple[Any, int]:
        """``(tree, step)``: the leaves of ``step`` (default: the latest
        committed) as tensors on ``device`` (default ``cuda``), in the
        structure of ``like`` (any pytree with the saved number of leaves;
        without it, the list of leaves)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.base}")
        dev = resolve_device(device)
        d = _step_dir(self.base, step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        tensors = [_decode(np.load(os.path.join(d, leaf["file"])), leaf["dtype"]).to(dev)
                   for leaf in manifest["leaves"]]
        if like is None:
            return tensors, step
        leaves_like, spec = _flatten(like)
        if len(tensors) != len(leaves_like):
            raise ValueError(f"tree structure changed: {len(tensors)} leaves saved, "
                             f"{len(leaves_like)} in like")
        return _unflatten(spec, tensors), step

    def _gc(self) -> None:
        steps = sorted(
            s for n in os.listdir(self.base)
            if (s := _parse_step(n)) is not None
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)
