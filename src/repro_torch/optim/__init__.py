"""Optimizers and distributed-optimization tricks (port of ``optim/``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamState,
    AdamW,
    apply_updates,
    constant_schedule,
    cosine_schedule,
    global_norm,
)
