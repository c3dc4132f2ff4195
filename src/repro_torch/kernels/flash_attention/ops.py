"""Model-layout dispatch for flash attention (port of
``kernels/flash_attention/ops.py``).

``flash_attention`` takes the model's grouped GQA layout (q [B,S,N,P,H],
k/v [B,S,N,H]).  A CPU tensor goes to the blocked plain version
``models.attention.attention_fwd``, as the JAX dispatcher does off the
TPU; a CUDA tensor goes to the kernel (``flash_attention_flat``) or the
call raises.  A ``meta`` tensor (a dry rank, ``launch/dryrun.py``) is a
third case that computes no value: the output is an empty tensor of the
kernel's shape, and the kernel's work (the band's operations under causal
and window skipping, its bytes) goes to the counting mode
(``_build.report_work``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_flat, work


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    B, S, N, P, H = q.shape
    if all(t.device.type == "meta" for t in (q, k, v)):
        _build.report_work(*work(B * N * P, B * N, S, k.shape[1], H, causal, window,
                                 q.element_size()))
        return torch.empty_like(q)
    if not _build.on_cuda(q, k, v):
        from repro_torch.models.attention import attention_fwd

        return attention_fwd(q, k, v, causal=causal, window=window)
    # rows (b, n, p) in that order, so q-row // P is kv-row (b, n)
    qf = q.movedim(1, 3).reshape(B * N * P, S, H).contiguous()
    kf = k.movedim(1, 2).reshape(B * N, S, H).contiguous()
    vf = v.movedim(1, 2).reshape(B * N, S, H).contiguous()
    out = flash_attention_flat(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, N, P, S, H).movedim(3, 1)   # [B,S,N,P,H]
