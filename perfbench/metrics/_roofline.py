"""The chip's peaks and the least time an outer iteration needs.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its
700 W limit.  The counts are the least the inputs need, copied from the
kernels' ``work`` arithmetic (``kernels/jacobi3d.work``: 18 operations a
cell for a sweep with its residual partial, 16 for a residual-only pass;
``kernels/residual_norm.work``: 3 a cell for the update-difference norm),
not imported from it:

* bytes — the state read once, b read once, the state written once, a
  cell an outer iteration, whatever the sweeps between read again;
* operations — 18 a cell for each inner sweep, and 3 for the non-blocking
  contribution's norm or 16 for the blocking protocol's exact residual.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

#: device name -> (HBM bytes/s, FLOP/s by dtype on the CUDA cores)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, {"float64": 34e12, "float32": 67e12}),
}

ITEMSIZE = {"float64": 8, "float32": 4}

SWEEP_OPS, RESIDUAL_OPS, DIFF_NORM_OPS = 18, 16, 3


def convdiff_outer(config: dict, mix) -> Tuple[float, float]:
    """(bytes, operations) an outer iteration needs on the whole grid."""
    cells = float(config["n"]) ** 3
    inner = float(np.mean(np.broadcast_to(mix.inner_sweeps, (int(config["shards"]),))))
    tail = RESIDUAL_OPS if mix.reduction == "blocking" else DIFF_NORM_OPS
    return 3 * ITEMSIZE[config["dtype"]] * cells, (SWEEP_OPS * inner + tail) * cells


def least_seconds(ctx) -> Optional[float]:
    """The least time of one outer iteration on ``ctx.device_kind``, or
    None where the family or the device has no count or peak here."""
    if ctx.config.get("family") != "convdiff" or ctx.device_kind not in PEAKS:
        return None
    bw, flops = PEAKS[ctx.device_kind]
    nbytes, ops = convdiff_outer(ctx.config, ctx.mix)
    return max(nbytes / bw, ops / flops[ctx.config["dtype"]])
