"""Reduction-mode registry — how a shard runtime produces its global residual.

* ``blocking``    — barrier semantics: the reduction is consumed the same
  step it is launched (monitor K forced to 0) and detection pays an extra
  exact residual pass on the critical path.
* ``nonblocking`` — the paper: the contribution is a free by-product, the
  reduction is in flight for K checks, detection leaves the critical path.
* ``rdoubling``   — modified recursive doubling (Zou & Magoulès): one
  XOR-partner butterfly round per outer step; a global value completes
  every log2(p) steps, so the mode carries its own pipeline staleness
  (monitor K forced to 0) and requires a power-of-two shard count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ReductionMode:
    """Static facts about one reduction strategy."""

    name: str
    barrier: bool                  # consumed the same step it is launched
    forces_zero_staleness: bool    # monitor K forced to 0
    requires_power_of_two: bool    # butterfly partner geometry
    topology: str                  # "flat" (sum/max) | "butterfly"
    extra_residual_pass: bool      # detection work on the critical path

    def rounds_per_value(self, p: int) -> int:
        """Outer steps between completed global values at shard count p
        (the mode's built-in pipeline staleness; 1 = every step)."""
        if self.topology == "butterfly":
            if p & (p - 1):
                raise ValueError(
                    f"{self.name} requires a power-of-two shard count, "
                    f"got {p}")
            return max(p.bit_length() - 1, 1)
        return 1

    def usable_shard_count(self, p: int) -> bool:
        """Can the mode run on p shards at all?"""
        return not (self.requires_power_of_two and p & (p - 1))


REDUCTION_MODES: Dict[str, ReductionMode] = {
    m.name: m
    for m in (
        ReductionMode(name="blocking", barrier=True,
                      forces_zero_staleness=True,
                      requires_power_of_two=False, topology="flat",
                      extra_residual_pass=True),
        ReductionMode(name="nonblocking", barrier=False,
                      forces_zero_staleness=False,
                      requires_power_of_two=False, topology="flat",
                      extra_residual_pass=False),
        ReductionMode(name="rdoubling", barrier=False,
                      forces_zero_staleness=True,
                      requires_power_of_two=True, topology="butterfly",
                      extra_residual_pass=False),
    )
}

#: canonical mode-name tuple
REDUCTIONS: Tuple[str, ...] = tuple(REDUCTION_MODES)


def get_reduction(name: str) -> ReductionMode:
    """Registry lookup; raises the validation error every runtime config
    shares."""
    try:
        return REDUCTION_MODES[name]
    except KeyError:
        raise ValueError(
            f"reduction {name!r} not in {REDUCTIONS}") from None
