"""Trace-driven replay + calibration.

* ``replay``    — per-worker partial-order replayer: re-executes a recorded
                  ``core.trace`` under modified assumptions (shard count,
                  reduction topology, stragglers) and predicts wall time,
                  detection step, and residual staleness at detection.
* ``calibrate`` — fit event-sim ``DelayModel`` distributions and replay
                  cost models from measured device traces, with a
                  goodness-of-fit report.
"""
from repro_torch.sim.replay import (  # noqa: F401
    CostModel,
    ReplayVerdict,
    WhatIf,
    what_if_table,
)
from repro_torch.sim.replay import replay as replay_trace  # noqa: F401
from repro_torch.sim.calibrate import fit_cost_model, fit_delay_model  # noqa: F401
