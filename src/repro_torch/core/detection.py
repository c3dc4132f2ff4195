"""Protocol-free convergence detection — the paper's contribution on tensors.

The paper terminates an asynchronous iterative process from the result of
*successive non-blocking reduction operations* over free-running local
residual contributions (PFAIT), instead of running a snapshot protocol.
The monitor holds a ring of ``K+1`` global-residual scalars: the reduction
"launched" at check ``k`` is only *consumed* (compared against ε) at check
``k+K``.  ``K = 0`` recovers classical blocking detection.

Four modes, mirroring the paper's head-to-head:

* ``sync``    — blocking exact reduction every check (baseline),
* ``pfait``   — the paper: stale reduction + tightened threshold ε = ε̃/margin,
* ``nfais2``  — candidate from the stale reduction must persist, then a
                *blocking exact verification* runs,
* ``nfais5``  — candidate must persist m checks, then be *confirmed* after m
                further checks (no data verification).

The state lives on the caller's device (f32 ring primed to +inf, int32
counters), and ``step`` is sync-free except for NFAIS2 with a verifier: the
JAX package's lazy ``lax.cond`` becomes a host branch on ``fire``, which
reads one flag per check and pays the exact verification only on a check
where a candidate fires.

``step`` is ``push`` (the ring: the new value in, the one launched K checks
ago out) then ``decide`` (the verdict on that visible value).  The shard
runtimes keep their reductions in flight themselves
(``runtime/transport.py``) and call ``decide`` on the value they waited
for, so both of their transports share the decision code.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import residual as res

MODES = ("sync", "pfait", "nfais2", "nfais5")

_INT32_MAX = torch.iinfo(torch.int32).max


@dataclass(frozen=True)
class MonitorConfig:
    """Static configuration of one convergence monitor.

    ``mode`` selects the detection protocol (``MODES``); ``eps`` is the
    already-tightened detection threshold ε (for PFAIT, ε̃/margin — see
    ``for_mode``); ``eps_tilde`` the user-facing target precision ε̃;
    ``staleness`` the reduction pipeline depth K (checks see a value K
    steps old — 0 means blocking); ``persistence`` the NFAIS repeat count
    m; ``ord`` the residual norm order l.
    """

    mode: str = "pfait"
    eps: float = 1e-6
    eps_tilde: float = 1e-6
    staleness: int = 2
    persistence: int = 4
    ord: float = 2.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.mode == "sync" and self.staleness != 0:
            object.__setattr__(self, "staleness", 0)

    @property
    def ring_len(self) -> int:
        """Staleness ring depth: K in-flight reductions + the visible slot."""
        return self.staleness + 1


class MonitorState(NamedTuple):
    """Monitor state, every field a tensor on the monitor's device."""

    ring: torch.Tensor               # f32[K+1] — in-flight reduction results
    step: torch.Tensor               # i32 — checks performed
    persist: torch.Tensor            # i32 — consecutive sub-ε checks (NFAIS)
    phase: torch.Tensor              # i32 — NFAIS5: 0 monitor, 1 confirm window
    confirm_at: torch.Tensor         # i32 — NFAIS5: step at which to confirm
    converged: torch.Tensor          # bool
    detected_residual: torch.Tensor  # f32 — the (stale) residual that fired
    verifications: torch.Tensor      # i32 — NFAIS2 blocking verifications paid


def init_state(cfg: MonitorConfig, device) -> MonitorState:
    """Fresh monitor state on ``device``: ring primed to +inf."""
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return MonitorState(
        ring=torch.full((cfg.ring_len,), float("inf"), dtype=torch.float32,
                        device=device),
        step=i32(0),
        persist=i32(0),
        phase=i32(0),
        confirm_at=i32(_INT32_MAX),
        converged=torch.zeros((), dtype=torch.bool, device=device),
        detected_residual=torch.full((), float("inf"), dtype=torch.float32,
                                     device=device),
        verifications=i32(0),
    )


def _push_ring(ring: torch.Tensor, value: torch.Tensor,
               step: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert the freshly-launched reduction; read the one launched K ago.

    Slot ``step mod L`` holds the value launched ``K+1`` steps ago (consumed
    last step), so the visible value sits at ``(step+1) mod L``; for L == 1
    it is the current value (blocking).  Indexing goes through
    ``index_select``/``index_copy`` so the device-resident step never has to
    be read on the host.
    """
    L = ring.shape[0]
    if L == 1:
        return value.reshape(1), value
    idx = torch.remainder(step, L).long().reshape(1)
    nxt = torch.remainder(step + 1, L).long().reshape(1)
    visible = ring.index_select(0, nxt).reshape(())
    return ring.index_copy(0, idx, value.reshape(1)), visible


def push(cfg: MonitorConfig, state: MonitorState,
         contribution: torch.Tensor) -> Tuple[MonitorState, torch.Tensor]:
    """Launch the check's reduction into the monitor's ring: σ of the
    already globally reduced, pre-σ ``contribution`` enters the ring, and
    the value launched K checks ago becomes visible.  Returns the state with
    the new ring and that visible value."""
    g = res.sigma(contribution, cfg.ord).to(torch.float32)
    ring, visible = _push_ring(state.ring, g, state.step)
    return state._replace(ring=ring), visible


def step(
    cfg: MonitorConfig,
    state: MonitorState,
    contribution: torch.Tensor,
    exact_residual_fn: Optional[Callable[[], torch.Tensor]] = None,
) -> MonitorState:
    """One detection check on an already globally reduced, pre-σ
    ``contribution``: ``push`` then ``decide``.

    ``exact_residual_fn`` — NFAIS2 only: a thunk evaluating the *exact*
    current global residual (blocking), called only on a check where a
    candidate fires.
    """
    state, visible = push(cfg, state, contribution)
    return decide(cfg, state, visible, exact_residual_fn)


def decide(
    cfg: MonitorConfig,
    state: MonitorState,
    visible: torch.Tensor,
    exact_residual_fn: Optional[Callable[[], torch.Tensor]] = None,
) -> MonitorState:
    """The check's decision on the ``visible`` global residual (f32, σ
    applied): the value launched K checks ago, from the monitor's own ring
    (``push``) or from a reduction that was in flight until this check
    (the distributed transport).  Advances ``step``; the ring is left as
    it is."""
    below = visible < cfg.eps
    inf = torch.full_like(visible, float("inf"))

    if cfg.mode in ("sync", "pfait"):
        return state._replace(
            step=state.step + 1,
            converged=state.converged | below,
            detected_residual=torch.where(
                state.converged, state.detected_residual,
                torch.where(below, visible, inf)),
        )

    zero = torch.zeros_like(state.persist)
    persist = torch.where(below, state.persist + 1, zero)

    if cfg.mode == "nfais2":
        fire = (persist >= cfg.persistence) & ~state.converged
        if exact_residual_fn is None:
            # no verifier supplied: the stale value stands in (the caller
            # accepts NFAIS5-like semantics)
            exact = torch.where(fire, visible, inf)
        elif bool(fire):
            exact = exact_residual_fn().to(torch.float32).reshape(())
        else:
            exact = inf
        verified = exact < cfg.eps_tilde
        return state._replace(
            step=state.step + 1,
            persist=torch.where(fire & ~verified, zero, persist),
            converged=state.converged | (fire & verified),
            detected_residual=torch.where(
                state.converged, state.detected_residual,
                torch.where(fire & verified, exact, inf)),
            verifications=state.verifications + fire.to(torch.int32),
        )

    # nfais5 — two-phase persistence confirmation
    candidate = (persist >= cfg.persistence) & (state.phase == 0)
    phase = torch.where(candidate, torch.ones_like(state.phase), state.phase)
    confirm_at = torch.where(candidate, state.step + cfg.persistence,
                             state.confirm_at)
    confirming = (state.phase == 1) & (state.step >= state.confirm_at)
    confirmed = confirming & below & (persist >= 2 * cfg.persistence)
    done = confirming  # failed | confirmed
    return state._replace(
        step=state.step + 1,
        persist=persist,
        phase=torch.where(done, zero, phase),
        confirm_at=torch.where(done, torch.full_like(confirm_at, _INT32_MAX),
                               confirm_at),
        converged=state.converged | confirmed,
        detected_residual=torch.where(
            state.converged, state.detected_residual,
            torch.where(confirmed, visible, inf)),
    )


def should_stop(state: MonitorState) -> torch.Tensor:
    """Loop predicate: True once the monitor has certified detection."""
    return state.converged


def pfait_threshold(eps_tilde: float, margin: float = 10.0) -> float:
    """PFAIT's tightened threshold ε = ε̃ / margin (paper §4.2)."""
    return eps_tilde / margin


def for_mode(mode: str, eps_tilde: float, margin: float = 10.0, **kw) -> MonitorConfig:
    """Monitor config for a protocol head-to-head at target precision ε̃."""
    eps = pfait_threshold(eps_tilde, margin) if mode == "pfait" else eps_tilde
    return MonitorConfig(mode=mode, eps=eps, eps_tilde=eps_tilde, **kw)
