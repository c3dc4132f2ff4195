"""Explicit bf16 tensor-parallel reductions (port of ``models/tp_reduce.py``).

GSPMD reduces the TP partial sums of a row-parallel dot in the dot's f32
accumulation type, so the wire carries f32; the port's default path does
the same (``layers.row_parallel``).  For the two down-projections
(attention output, MLP down) ``tp_matmul_psum`` instead runs the dot
locally with f32 accumulation, casts its partial to bf16 and sums the bf16
partials over ``model``: the cross-rank payload is half the bytes.

Enabled by ``ParallelConfig.tp_reduce_bf16``, in train mode only (JAX's
``Model._ctx``); every other path keeps the f32 reduction, so both
variants are measurable.  JAX wraps the dot in ``shard_map``; here each
rank already holds its block of ``h`` and ``w``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.collectives import reduce_from


def tp_matmul_psum(
    h: torch.Tensor,     # [B, S, F/tp]: this rank's block of F
    w: torch.Tensor,     # [F/tp, D]: this rank's rows
    mesh,
    dp_axes: Tuple[str, ...],
    model_axis: str = "model",
) -> torch.Tensor:
    """h @ w with an explicit bf16 all-reduce over the model axis; returns
    bf16 [B, S, D].  (``dp_axes``: the batch rows are already this rank's.)"""
    wb = w.to(torch.bfloat16).to(torch.promote_types(h.dtype, torch.bfloat16))
    partial_out = torch.einsum("bsf,fd->bsd", h, wb)
    return reduce_from(partial_out.to(torch.bfloat16), mesh, model_axis)
