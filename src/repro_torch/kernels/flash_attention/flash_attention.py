"""Wrapper of the flash attention CUDA kernel (``csrc/flash_attention.cu``),
the port of ``kernels/flash_attention/flash_attention.py::flash_attention_flat``.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises: bf16 inputs the tensor-core kernel, f32
inputs the f32 (CUDA-core) kernel.  ``LAUNCHES`` counts launches of both;
``LAUNCH_SHAPES`` counts the same launches by shape.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import INT, PTR
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LAUNCHES: Dict[str, int] = {"flash_attention_flat": 0}
# (BH, BN, Sq, Skv, H, causal, window, "bf16"/"f32") -> launches
LAUNCH_SHAPES: Counter = Counter()

HEAD_DIMS = (16, 32, 64, 128)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (q, k, v, o, BH, BN, Sq, Skv, H, causal, window, stream)
_SIGNATURES = {f"flash_attention_{s}": (PTR,) * 4 + (INT,) * 7 + (PTR,)
               for s in _SUFFIX.values()}

_build.register_counters(LAUNCHES, LAUNCH_SHAPES)


def band(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (q, kv) pairs the kernel computes: every pair without ``causal``,
    else those with kv ≤ q (both from 0), cut to the ``window`` latest."""
    if not causal:
        return Sq * Skv
    if Sq > Skv:   # rows past the last key: counted one by one
        return sum(max(0, min(q, Skv - 1) - max(0, q - window + 1 if window else 0) + 1)
                   for q in range(Sq))
    cap = min(Skv, window) if window else Skv
    n = min(Sq, cap)   # rows q < cap see q + 1 pairs, the rest cap
    return n * (n + 1) // 2 + (Sq - n) * cap


def work(BH: int, BN: int, Sq: int, Skv: int, H: int, causal: bool, window: int,
         itemsize: int):
    """(operations, bytes) of one launch: 4·H multiply-adds of QKᵀ and PV
    per pair of the band, q / k / v read once and o written once."""
    return (4 * H * BH * band(Sq, Skv, causal, window),
            itemsize * H * (2 * BH * Sq + 2 * BN * Skv))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention, q [BH, Sq, H] against k/v
    [BN, Skv, H] (GQA: q-row ``bh`` reads kv-row ``bh // (BH // BN)``) →
    [BH, Sq, H] in q's dtype.  Any ``Sq``/``Skv``: the kernel clips its last
    tiles."""
    if not _build.on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"need q [BH, Sq, H] and k/v [BN, Skv, H], got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    BH, Sq, H = q.shape
    BN, Skv, Hk = k.shape
    if Hk != H or H not in HEAD_DIMS:
        raise ValueError(f"head dim must match and be one of {HEAD_DIMS}, got {H}/{Hk}")
    if BN < 1 or BH % BN or min(Sq, Skv) < 1:
        raise ValueError(f"need BH a multiple of BN and non-empty sequences, got "
                         f"BH={BH} BN={BN} Sq={Sq} Skv={Skv}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUFFIX:
        raise TypeError(f"need matching f32/bf16 inputs, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel inputs must start on a 16-byte boundary")
    out = torch.empty_like(q)
    fn = getattr(_build.load("flash_attention", _SIGNATURES),
                 f"flash_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, BN, Sq,
                 Skv, H, int(causal), int(window),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_flat")
    _build.report_work(*work(BH, BN, Sq, Skv, H, causal, window, q.element_size()))
    LAUNCHES["flash_attention_flat"] += 1
    LAUNCH_SHAPES[BH, BN, Sq, Skv, H, bool(causal), int(window), _SUFFIX[q.dtype]] += 1
    return out
