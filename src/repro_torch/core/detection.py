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

The second half of the module runs many monitors at once: ``batched_monitor``
over a (seed × ε × K × m) grid, and the lane lifecycle a detection service
packs tenants into (``init_lanes``, ``reset_lanes``, ``make_lane_runner``),
where one lane runner on the card captures a whole chunk of problem steps
and monitor checks in one CUDA graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import residual as res
from repro_torch.core.spans import host_read
from repro_torch.kernels import _build

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
        elif host_read(fire):
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


# ---------------------------------------------------------------------------
# Batched detection sweeps — every (seed × ε × K × m) lane in one pass
# ---------------------------------------------------------------------------
#
# ``step`` monitors one configuration; parameter studies need thousands.
# ``batched_monitor`` runs a staleness-*dynamic* form of the same update on
# ``[S, lanes]`` tensors: the ring is padded to the grid's largest K+1 and
# indexed ``step mod (K_lane+1)``, so lanes of different depths share one
# loop.  Every lane performs the same float operations in the same order
# as ``step`` (comparisons and selects on f32 values, σ applied first), and
# the padding slots are never read, so the verdicts are bitwise those of
# the per-configuration loop.  NFAIS2 lanes use ``step``'s verifier-free
# fallback (the candidate's stale value stands in for the verification).


class BatchedVerdict(NamedTuple):
    """Per-lane outcome, shaped [S, E, K, M] (seed × ε × staleness × m)."""

    converged: torch.Tensor          # bool — detection fired within T checks
    detect_step: torch.Tensor        # i32 — first firing check (-1 if never)
    detected_residual: torch.Tensor  # f32 — the (stale) residual that fired
    verifications: torch.Tensor      # i32 — NFAIS2 verification count


class _LaneState(NamedTuple):
    """Monitor state of a set of lanes; every field shaped like the lanes
    (``ring`` has one more axis, the ring slots)."""

    ring: torch.Tensor
    step: torch.Tensor
    persist: torch.Tensor
    phase: torch.Tensor
    confirm_at: torch.Tensor
    converged: torch.Tensor
    detected: torch.Tensor
    verifications: torch.Tensor
    detect_step: torch.Tensor


#: public alias — the per-lane monitor state carried by the lane runner
LaneState = _LaneState


def _sigma_lane(c: torch.Tensor, ord: float) -> torch.Tensor:
    """Elementwise σ of already reduced contributions: the identity for
    l∞, the l-th root otherwise (``sqrt`` for l2, ``** 1.0`` for l1)."""
    if np.isinf(ord):
        return c
    if ord == 2.0:
        return torch.sqrt(c)
    return c ** (1.0 / ord)


def _lane_step(mode: str, s: _LaneState, g: torch.Tensor, eps: torch.Tensor,
               eps_tilde: torch.Tensor, K: torch.Tensor, m: torch.Tensor) -> _LaneState:
    """``step`` with per-lane ε, ε̃, K and m (tensors broadcast against the
    lanes), line by line; K is dynamic through mod-(K+1) ring indexing."""
    L = K + 1
    idx = torch.remainder(s.step, L).long().unsqueeze(-1)
    nxt = torch.remainder(s.step + 1, L).long().unsqueeze(-1)
    visible = torch.where(K == 0, g, s.ring.gather(-1, nxt).squeeze(-1))
    ring = s.ring.scatter(-1, idx, g.unsqueeze(-1))
    below = visible < eps
    inf = torch.full_like(visible, float("inf"))
    zero = torch.zeros_like(s.persist)

    if mode in ("sync", "pfait"):
        converged = s.converged | below
        return s._replace(
            ring=ring, step=s.step + 1, converged=converged,
            detected=torch.where(s.converged, s.detected,
                                 torch.where(below, visible, inf)),
            detect_step=torch.where(converged & ~s.converged, s.step,
                                    s.detect_step))

    persist = torch.where(below, s.persist + 1, zero)

    if mode == "nfais2":
        fire = (persist >= m) & ~s.converged
        exact = torch.where(fire, visible, inf)   # verifier-free fallback
        verified = exact < eps_tilde
        converged = s.converged | (fire & verified)
        return s._replace(
            ring=ring, step=s.step + 1,
            persist=torch.where(fire & ~verified, zero, persist),
            converged=converged,
            detected=torch.where(s.converged, s.detected,
                                 torch.where(fire & verified, exact, inf)),
            verifications=s.verifications + fire.to(torch.int32),
            detect_step=torch.where(converged & ~s.converged, s.step,
                                    s.detect_step))

    # nfais5 — two-phase persistence confirmation
    candidate = (persist >= m) & (s.phase == 0)
    phase = torch.where(candidate, torch.ones_like(s.phase), s.phase)
    confirm_at = torch.where(candidate, s.step + m, s.confirm_at)
    confirming = (s.phase == 1) & (s.step >= s.confirm_at)
    confirmed = confirming & below & (persist >= 2 * m)
    converged = s.converged | confirmed
    done = confirming  # failed | confirmed
    return s._replace(
        ring=ring, step=s.step + 1, persist=persist,
        phase=torch.where(done, zero, phase),
        confirm_at=torch.where(done, torch.full_like(confirm_at, _INT32_MAX),
                               confirm_at),
        converged=converged,
        detected=torch.where(s.converged, s.detected,
                             torch.where(confirmed, visible, inf)),
        detect_step=torch.where(converged & ~s.converged, s.step, s.detect_step))


def _fresh_lanes(shape: Tuple[int, ...], ring_len: int, device) -> _LaneState:
    def i32(v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    return _LaneState(
        ring=torch.full(shape + (ring_len,), float("inf"), dtype=torch.float32,
                        device=device),
        step=i32(0), persist=i32(0), phase=i32(0), confirm_at=i32(_INT32_MAX),
        converged=torch.zeros(shape, dtype=torch.bool, device=device),
        detected=torch.full(shape, float("inf"), dtype=torch.float32, device=device),
        verifications=i32(0), detect_step=i32(-1))


def batched_monitor(mode: str, contribs, eps, staleness, persistence,
                    ord: float = 2.0, eps_tilde=None, device: DeviceLike = None
                    ) -> BatchedVerdict:
    """Run the detection monitor over a full (seed × ε × K × m) grid.

    ``contribs`` — ``[S, T]``: per-seed series of already globally reduced
    contribution sums (pre-σ), one per check, cast to f32.  The grid runs on
    ``device``: by default a CUDA tensor's own card, and the card for
    anything else (an array, a CPU tensor) unless the caller asks for the
    CPU.  ``eps`` [E], ``staleness`` [K] and ``persistence`` [M] are 1-D
    grids; ``eps_tilde`` defaults to ``eps``.  ``sync`` forces K = 0, as
    ``MonitorConfig`` does.

    Returns a ``BatchedVerdict`` of ``[S, E, K, M]`` tensors, bitwise the
    per-configuration ``step`` loop's verdicts.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    eps = np.asarray(eps, dtype=np.float32).reshape(-1)
    epst = (np.asarray(eps_tilde, dtype=np.float32).reshape(-1)
            if eps_tilde is not None else eps)
    if epst.shape != eps.shape:
        raise ValueError("eps_tilde grid must match eps grid")
    stal = np.asarray(staleness, dtype=np.int32).reshape(-1)
    if mode == "sync":
        stal = np.zeros_like(stal)
    pers = np.asarray(persistence, dtype=np.int32).reshape(-1)
    E, K, M = eps.size, stal.size, pers.size
    eps_g, stal_g, pers_g = np.meshgrid(eps, stal, pers, indexing="ij")
    epst_g = np.broadcast_to(epst[:, None, None], eps_g.shape)
    if device is None and isinstance(contribs, torch.Tensor) and contribs.is_cuda:
        dev = contribs.device
    else:
        dev = resolve_device(device)
    cs = torch.as_tensor(contribs).to(device=dev, dtype=torch.float32)
    S = cs.shape[0]
    lanes = [torch.as_tensor(np.array(a).reshape(-1), device=dev)
             for a in (eps_g, epst_g, stal_g, pers_g)]
    nl = lanes[0].numel()
    state = _fresh_lanes((S, nl), int(stal.max()) + 1, dev)
    for t in range(cs.shape[1]):
        g = _sigma_lane(cs[:, t], float(ord))[:, None].expand(S, nl)
        state = _lane_step(mode, state, g, *lanes)
    shape = (S, E, K, M)
    return BatchedVerdict(
        converged=state.converged.reshape(shape),
        detect_step=state.detect_step.reshape(shape),
        detected_residual=state.detected.reshape(shape),
        verifications=state.verifications.reshape(shape))


# ---------------------------------------------------------------------------
# Lane lifecycle — pack / retire / refill without a rebuild
# ---------------------------------------------------------------------------
#
# A detection service advances resident lanes chunk by chunk, retiring a
# tenant when its detection fires and refilling its lane from the queue:
#
# * ``init_lanes``       — fresh [L] lane states (ring padded to the
#   service's largest K+1; padding slots are never read),
# * ``reset_lanes``      — re-initialise a masked subset with ``torch.where``
#   (shapes unchanged; the caller copies the result into its buffers),
# * ``make_lane_runner`` — one chunk of problem steps and monitor checks.
#   On the card its first call captures the chunk in a CUDA graph (the
#   counterpart of JAX's jit compile) and every later call replays it, so
#   the lanes' tensors are persistent buffers the chunk updates in place.


def init_lanes(nlanes: int, ring_len: int, device: DeviceLike = None) -> _LaneState:
    """Fresh monitor state for ``nlanes`` independent detection lanes on
    ``device`` (the card unless the caller asks for the CPU).

    ``ring_len`` must be ≥ the largest per-lane ``K + 1`` the lanes will
    ever be configured with; oversizing it only pads.
    """
    if nlanes < 1 or ring_len < 1:
        raise ValueError(f"need nlanes>=1, ring_len>=1, got {nlanes}/{ring_len}")
    return _fresh_lanes((int(nlanes),), int(ring_len), resolve_device(device))


def lane_step_batched(mode: str, state: _LaneState, g: torch.Tensor,
                      eps: torch.Tensor, eps_tilde: torch.Tensor,
                      K: torch.Tensor, m: torch.Tensor) -> _LaneState:
    """One monitor check on every lane: ``g`` is the per-lane σ-applied
    global residual ([L], f32); ε, ε̃ (f32), K and m (int32) are per lane."""
    return _lane_step(mode, state, g, eps, eps_tilde, K, m)


def reset_lanes(state: _LaneState, mask) -> _LaneState:
    """Re-initialise the lanes where ``mask`` is True (retire + refill):
    ``torch.where`` on every field, shapes unchanged; untouched lanes carry
    their state bitwise."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=state.step.device)
    fresh = _fresh_lanes(tuple(state.step.shape), state.ring.shape[-1],
                         state.step.device)
    return _LaneState(*(torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim())),
                                    new, old)
                        for old, new in zip(state, fresh)))


class _LaneRunner:
    """``make_lane_runner``'s chunk program (see there)."""

    def __init__(self, mode: str, step_fn, chunk: int, ord: float):
        self.mode, self.step_fn, self.chunk, self.ord = mode, step_fn, int(chunk), ord
        self.captured: Optional[_build.CountedGraph] = None
        self.capture_s = 0.0   # wall of the warm-up and capture
        self._key: Tuple[int, ...] = ()
        self._cs: Optional[torch.Tensor] = None

    def run_eager(self, X, ops, state, eps, eps_tilde, K, m):
        """The chunk run op by op on any device, never captured: writes the
        final X and lane state into ``X`` and ``state`` and returns them with
        the raw series [L, chunk]."""
        Xc, s, cs = X, state, []
        for _ in range(self.chunk):
            Xc, contrib = self.step_fn(Xc, ops)
            c32 = contrib.to(torch.float32)
            s = _lane_step(self.mode, s, _sigma_lane(c32, self.ord), eps, eps_tilde, K, m)
            cs.append(c32)
        X.copy_(Xc)
        for dst, src in zip(state, s):
            dst.copy_(src)
        return X, state, torch.stack(cs, dim=1)

    def __call__(self, X, ops, state, eps, eps_tilde, K, m):
        if not X.is_cuda:
            return self.run_eager(X, ops, state, eps, eps_tilde, K, m)
        key = tuple(t.data_ptr() for t in (X, *ops.values(), *state, eps, eps_tilde, K, m))
        if self.captured is None:
            t0 = time.perf_counter()
            self._capture(X, ops, state, eps, eps_tilde, K, m)
            self.capture_s = time.perf_counter() - t0
            self._key = key
        elif key != self._key:
            raise ValueError("a captured lane runner replays on the buffers it "
                             "captured: write new lanes into them in place")
        self.captured.replay()
        return X, state, self._cs

    def _capture(self, X, ops, state, eps, eps_tilde, K, m) -> None:
        dev = X.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # warm-up on copies: kernel libraries load and lazy handles are
            # made outside the capture; the buffers are not touched
            _, cw = self.step_fn(X.clone(), ops)
            _lane_step(self.mode, _LaneState(*(t.clone() for t in state)),
                       _sigma_lane(cw.to(torch.float32), self.ord), eps, eps_tilde, K, m)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = _build.CountedGraph()
        with graph.capture():
            _, _, cs = self.run_eager(X, ops, state, eps, eps_tilde, K, m)
        self.captured, self._cs = graph, cs


def make_lane_runner(mode: str, step_fn, chunk: int, ord: float = 2.0):
    """Build the chunk program of a lane bucket.

    ``step_fn(X, ops) -> (X_next, contrib[L])`` — a batched problem step
    (the solvers' ``update_with_residual_batched`` closed over a shared
    geometry instance, the per-lane operands passed as the ``ops`` dict so
    that refilling a lane swaps rows, never shapes).

    Returns ``run(X, ops, state, eps, eps_tilde, K, m) -> (X, state,
    contribs[L, chunk])``: ``chunk`` steps, each followed by a monitor
    check on every lane.  ``X`` and the lane ``state`` are updated in place
    and returned; ``contribs`` is the raw (pre-σ, f32) per-lane series of
    the chunk, so a tenant's recorded series fed to ``batched_monitor``
    gives its verdict bitwise.  The batched step is synchronous, so the
    σ-applied series is the exact residual trace an oracle scores.

    On a CUDA ``X`` the first call captures the chunk in a CUDA graph
    (``kernels/_build.CountedGraph``) and every call replays it: the
    arguments must then be the same persistent tensors at every call
    (written in place between calls, never rebound; anything else raises),
    and the returned ``contribs`` is the graph's own output tensor, valid
    until the next replay.  On the CPU the chunk runs eagerly, as
    ``run.run_eager`` runs it on any device.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    return _LaneRunner(mode, step_fn, chunk, float(ord))


def contribution_series(step_fn, x0: torch.Tensor, T: int) -> torch.Tensor:
    """``[S, T]`` pre-step contribution series of a batched problem step
    ``step_fn(X) -> (X_next, contrib[S])`` run T times from ``x0``."""
    X, cs = x0, []
    for _ in range(int(T)):
        X, c = step_fn(X)
        cs.append(c)
    return torch.stack(cs, dim=1)
