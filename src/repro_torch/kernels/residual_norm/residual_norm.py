"""Wrapper of the diff-norm partials CUDA kernel (``csrc/residual_norm.cu``).

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.residual import partial_mode
from repro_torch.kernels import _build
from repro_torch.kernels._build import INT, LONG, PTR
from repro_torch.kernels.residual_norm.ref import diff_norm_partials_ref

LAUNCHES: Dict[str, int] = {"diff_norm_partials": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
# (a, b, parts, n, block, mode, stream)
_SIGNATURES = {f"diff_norm_partials_{s}": (PTR, PTR, PTR, LONG, LONG, INT, PTR)
               for s in _SUFFIX.values()}

_build.register_counters(LAUNCHES)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def diff_norm_partials(a: torch.Tensor, b: torch.Tensor, block: int = 65536,
                       ord: float = float("inf")) -> torch.Tensor:
    """Flattens the inputs and returns per-``block`` partials ``[nblocks]``
    (f32) of ``max|a−b|`` (ord ∞), ``Σ(a−b)²`` (2) or ``Σ|a−b|`` (1)."""
    if not _build.on_cuda(a, b):
        return diff_norm_partials_ref(a, b, block=block, ord=ord)
    mode = partial_mode(ord)
    if a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"need equal non-empty shapes, got {tuple(a.shape)}/{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _SUFFIX:
        raise TypeError(f"need matching f64/f32/bf16 inputs, got {a.dtype}/{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    n = a.numel()
    block = min(block, n)
    parts = torch.empty((-(-n // block),), dtype=torch.float32, device=a.device)
    fn = getattr(_build.load("residual_norm", _SIGNATURES),
                 f"diff_norm_partials_{_SUFFIX[a.dtype]}")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), parts.data_ptr(), n, block,
                 mode, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "diff_norm_partials")
    LAUNCHES["diff_norm_partials"] += 1
    return parts
