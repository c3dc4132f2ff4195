"""The one generator of traffic: a mix file's parameters as the program's
detection protocol and asynchrony knobs, and the closed stream of solves.

A mix (``traffic/<name>.json``) holds:

* ``protocol`` — ``mode`` (sync, pfait, nfais2, nfais5), ``reduction``
  (blocking, nonblocking, rdoubling), ``staleness`` K and ``margin``;
* ``knobs`` — ``inner_sweeps``, ``halo_delay`` and ``contrib_lag``, each a
  scalar or one value a shard;
* ``max_outer`` — the most outer iterations a solve may run;
* ``warm_outer`` — the outer iterations of each of set-up's two warm-up
  solves, the second of which gives the rate that caps a solve near the
  window's end.

One caller drives a closed loop: it starts the next solve when the last
one returns.  Solve ``i`` of a run draws its inputs (in the configuration's
family) from ``solve_seed(seed, i)``, so the same seed gives the same
stream."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

Knob = Union[int, Sequence[int]]

_MASK = (1 << 63) - 1


def solve_seed(seed: int, index: int) -> int:
    """A 63-bit seed for solve ``index`` of run ``seed`` (splitmix64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK


@dataclass(frozen=True)
class Mix:
    """A traffic mix, validated."""

    mode: str
    reduction: str
    staleness: int
    margin: float
    inner_sweeps: Knob
    halo_delay: Knob
    contrib_lag: Knob
    max_outer: int
    warm_outer: int

    @staticmethod
    def read(traffic: dict) -> "Mix":
        proto, knobs = traffic["protocol"], traffic.get("knobs", {})
        mix = Mix(mode=proto["mode"], reduction=proto["reduction"],
                  staleness=int(proto.get("staleness", 0)),
                  margin=float(proto.get("margin", 1.0)),
                  inner_sweeps=knobs.get("inner_sweeps", 1),
                  halo_delay=knobs.get("halo_delay", 0),
                  contrib_lag=knobs.get("contrib_lag", 0),
                  max_outer=int(traffic["max_outer"]),
                  warm_outer=int(traffic.get("warm_outer", 2)))
        if min(mix.max_outer, mix.warm_outer) < 1:
            raise ValueError("max_outer and warm_outer must be >= 1")
        return mix

    @property
    def staleness_seen(self) -> int:
        """K as the monitor runs it: a blocking reduction sees its value at
        the same check."""
        return 0 if self.reduction == "blocking" or self.mode == "sync" else self.staleness

    def eps(self, eps_tilde: float) -> float:
        """The detection threshold: ε̃ / margin for PFAIT, ε̃ otherwise."""
        return eps_tilde / self.margin if self.mode == "pfait" else eps_tilde
