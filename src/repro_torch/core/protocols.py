"""Event-level detection protocols (paper §3 + refs [12, 15, 6]); the
port's copy of the JAX package's ``core/protocols.py``.

Each protocol plugs into ``core.async_engine.AsyncEngine`` via four hooks:

    on_start(engine, t)            — simulation begins
    on_iteration(engine, i, t, r)  — worker i finished a sweep, local residual r
    on_data(engine, msg, t)        — a computation message was delivered
    on_message(engine, msg, t)     — a protocol message was delivered

Implemented protocols:

* ``PFAIT``             — the paper: successive non-blocking reductions over
                          live local residuals; zero protocol messages.
* ``NFAIS2``            — SB96-style snapshot [15]/[12]: snapshot messages
                          *carry interface data* → consistent records, exact
                          residual of the snapshot vector; O(n) msg bytes.
* ``NFAIS5``            — approximate snapshot [12]: empty snapshot messages
                          record last-delivered dependencies; persistence m +
                          confirmation phase; O(1) msg bytes, residual exact
                          up to (1+c(p,m))ε.
* ``ExactSnapshotFIFO`` — Chandy–Lamport marker protocol [6] adapted to
                          asynchronous iterations [12]; requires FIFO
                          channels; consistent cut → exact residual.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.async_engine import AsyncEngine, Msg
from repro_torch.core.residual import combine_contributions


class BaseProtocol:
    name = "base"
    #: what a detection *claims* (the reliability oracle scores against it):
    #: "live"     — the live global residual is < ε (PFAIT samples live
    #:              state; NFAIS5 records approximate, data-free views),
    #: "recorded" — a recorded consistent global vector has residual < ε
    #:              (NFAIS2 / Chandy–Lamport carry or pin the actual data;
    #:              the certified solution is the record, not whatever the
    #:              live state drifts to before the stop broadcast lands).
    claim = "live"

    def __init__(self, eps: float, ord: float = 2.0):
        self.eps = float(eps)
        self.ord = ord

    def recorded_vector(self):
        """The recorded global vector backing a "recorded" claim (list of
        per-worker blocks), or None when the protocol has no record."""
        return None

    def on_start(self, eng: AsyncEngine, t: float) -> None:  # pragma: no cover
        pass

    def on_iteration(self, eng: AsyncEngine, i: int, t: float, r_i: float) -> None:
        pass

    def on_data(self, eng: AsyncEngine, msg: Msg, t: float) -> None:
        pass

    def on_message(self, eng: AsyncEngine, msg: Msg, t: float) -> None:
        pass

    def wants_residual(self, eng: AsyncEngine, i: int) -> bool:
        """Will ``on_iteration`` consume ``r_i`` for worker i this iteration?
        The engine's fused path skips residual evaluation when False (the
        protocol then receives ``r_i = NaN``)."""
        return True

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        """The participant set changed (kind ∈ {"crash", "join", "restore"},
        core.scenarios membership primitives).  Default: no bookkeeping —
        PFAIT's reductions are re-launched over the live active set anyway;
        snapshot protocols override to invalidate their records (a record
        quorum taken over the old membership certifies the wrong system)."""
        pass

    # shared helper: tree-reduction completion latency
    def _reduce_latency(self, eng: AsyncEngine) -> float:
        return 2 * math.ceil(math.log2(max(eng.p, 2))) * eng.cfg.hop_latency

    # shared helper: residual of a *complete* recorded view (snapshot
    # reduce paths guarantee every neighbour is present, so the problem's
    # buffered fast path is valid; gated on cfg.fused so the unfused
    # baseline keeps the plain local_residual path)
    def _record_residual(self, eng: AsyncEngine, i: int, own, deps) -> float:
        if eng.cfg.fused:
            fast = getattr(eng.problem, "local_residual_fast", None)
            if fast is not None:
                return fast(i, own, deps)
        return eng.problem.local_residual(i, own, deps)

    # shared helper for the snapshot protocols under dynamic membership: a
    # crashed neighbour sends no snapshot message, but its interface is
    # frozen boundary data — complete the record with the current delivered
    # view (identical to the frozen worker's last sent interface once
    # in-flight messages drain).  No-op (returns the record unchanged) when
    # every neighbour is active.
    def _record_deps_with_boundary(self, eng: AsyncEngine, i: int) -> Dict:
        deps = self.rec_deps[i]
        missing = [j for j in eng.problem.neighbors(i)
                   if j not in deps and not eng.active[j]]
        if not missing:
            return deps
        out = dict(deps)
        for j in missing:
            out[j] = eng.deps[i][j]
        return out


# ---------------------------------------------------------------------------
# PFAIT — the paper's protocol-free termination
# ---------------------------------------------------------------------------


class PFAIT(BaseProtocol):
    """Successive non-blocking reductions of free-running local residuals.

    Contributions are sampled at staggered times from each worker's *live*
    state (stale dependency views included) — the source of the detection
    inconsistency the paper calibrates away with the ε-margin.
    """

    name = "pfait"

    def wants_residual(self, eng: AsyncEngine, i: int) -> bool:
        # Zero per-iteration detection work: contributions are sampled from
        # live state by the reduction service, never from on_iteration.
        return False

    def on_start(self, eng: AsyncEngine, t: float) -> None:
        self._gen = 0
        self._launch(eng, t)

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        # In-flight reductions carry samples of *pre-change* state.  For a
        # crash that is harmless (the survivors' residuals keep shrinking),
        # but a join or checkpoint-restore makes convergence non-monotone:
        # a reduction whose samples all predate a rollback would certify a
        # state that no longer exists (observed as a false detection on the
        # crash_restart scenario).  Membership changes are engine-visible
        # events, so the honest semantics is the elastic one: discard every
        # chain sampled under the old membership and relaunch fresh.
        self._gen += 1
        self._launch(eng, t)

    def _launch(self, eng: AsyncEngine, t: float) -> None:
        if eng.detect_time is not None:
            return
        gen = self._gen

        def complete(contribs: np.ndarray, tc: float) -> None:
            if gen != self._gen:
                return  # superseded chain: sampled under old membership
            # NaN slots are workers outside the membership at launch or
            # crashed before their sample time — the reduction spans the
            # remaining participants (protocol-free: no bookkeeping, the
            # next launch simply covers the new active set)
            vals = contribs[~np.isnan(contribs)]
            if vals.size == 0:
                self._launch(eng, tc)
                return
            g = combine_contributions(vals, self.ord)
            if g < self.eps:
                eng.terminate(tc, g)
            else:
                self._launch(eng, tc)

        eng.start_reduction(
            sample_fn=lambda i, ts: eng.live_local_residual(i),
            on_complete=complete,
            t=t,
        )


# ---------------------------------------------------------------------------
# Modified recursive doubling — decentralised reduction protocol baseline
# ---------------------------------------------------------------------------


class RecursiveDoublingProtocol(BaseProtocol):
    """Modified recursive doubling (Zou & Magoulès 2019): the protocol-based
    alternative the shard runtime benchmarks PFAIT against on device.

    Workers run free-running reduction *epochs* over the butterfly: in round
    r of an epoch, worker i exchanges its partial residual sum with partner
    ``i XOR 2^r``; after log2(p) rounds every worker holds the epoch's
    global sum and checks it against ε *independently* (no root, no
    broadcast tree).  Contributions are sampled from live state at each
    worker's epoch start — staggered like PFAIT's, so the detection claim
    is "live" and the ε-margin methodology applies unchanged.  Unlike PFAIT
    the reduction itself is carried by point-to-point protocol messages
    (p·log2(p) per epoch), which is exactly the overhead the paper's
    protocol-free detection removes.

    Requires a power-of-two worker count (the classic butterfly); the
    on-device twin lives in ``runtime/shard_runtime.py`` (``rdoubling``).
    """

    name = "rdub"

    #: sentinel "rounds" for the non-power-of-two remainder fold: at epoch
    #: start an extra rank pre-combines its contribution into a butterfly
    #: participant (FOLD) and receives the epoch total back (RESULT) — the
    #: classic MPI reduce trick that generalises the butterfly to any
    #: membership size after a crash/join
    FOLD = -1
    RESULT = -2

    def __init__(self, eps: float, ord: float = 2.0):
        super().__init__(eps, ord)

    def wants_residual(self, eng: AsyncEngine, i: int) -> bool:
        # like PFAIT: contributions are sampled from live state at epoch
        # starts, never from per-iteration residuals
        return False

    def _acc(self, a: float, b: float) -> float:
        return max(a, b) if math.isinf(self.ord) else a + b

    @staticmethod
    def _geometry(m: int) -> Tuple[int, int, int, int]:
        """(m, q, rounds, rem): q = largest power of two ≤ m runs the
        butterfly; rem = m − q extra ranks fold into ranks 0..rem−1."""
        q = 1 << (m.bit_length() - 1)
        return m, q, q.bit_length() - 1, m - q

    def on_start(self, eng: AsyncEngine, t: float) -> None:
        p = eng.p
        if p & (p - 1):
            raise ValueError(
                f"RecursiveDoublingProtocol requires a power-of-two worker "
                f"count, got p={p}")
        # epoch/round messages are stamped with a membership generation:
        # a crash/join bumps it and restarts every epoch over the new
        # member list, so stragglers from the old geometry are discarded
        self.generation = 0
        self.members: Tuple[int, ...] = tuple(eng.active_workers())
        self._geom = self._geometry(max(len(self.members), 1))
        self.epoch = [0] * p
        self.rnd = [0] * p
        self.partial = [0.0] * p
        self.folded = [True] * p
        # out-of-order buffer: partner partials keyed by (epoch, round) —
        # bounded, because a partner cannot advance a round without our
        # reply for the previous one
        self.pending: List[Dict[Tuple[int, int], float]] = [
            dict() for _ in range(p)]
        for i in self.members:
            self._begin_epoch(eng, i, t)

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        if eng.detect_time is not None:
            return
        self.generation += 1
        self.members = tuple(eng.active_workers())
        for buf in self.pending:
            buf.clear()
        if not self.members:
            return
        self._geom = self._geometry(len(self.members))
        # epoch counters restart from a common base: workers completed
        # *different* epoch counts in the old generation, and partners key
        # buffered partials by (epoch, round) — mismatched absolute counters
        # would deadlock the new butterfly (the generation stamp already
        # quarantines every old-geometry message)
        self.epoch = [0] * eng.p
        for i in self.members:
            self._begin_epoch(eng, i, t)

    def _begin_epoch(self, eng: AsyncEngine, i: int, t: float) -> None:
        self.partial[i] = eng.live_local_residual(i)
        self.rnd[i] = 0
        eng.reductions_started += 1
        m, q, rounds, rem = self._geom
        if m == 1:
            # the local contribution is the global sum; re-check at
            # reduction cadence instead of recursing at frozen virtual time
            gen = self.generation
            g = combine_contributions([self.partial[i]], self.ord)
            if g < self.eps:
                eng.terminate(t, g)
            else:
                def again(tt, _i=i, _gen=gen):
                    if _gen == self.generation and eng.detect_time is None:
                        self._begin_epoch(eng, _i, tt)
                eng.schedule(t + 2 * eng.cfg.hop_latency, "callback", again)
            return
        r = self.members.index(i)
        if r >= q:
            # extra rank: fold into the partner, await the epoch RESULT
            eng.send(
                Msg(src=i, dst=self.members[r - q], kind="rdub",
                    payload=(self.generation, self.epoch[i], self.FOLD,
                             self.partial[i])),
                t,
            )
            return
        self.folded[i] = (r + q >= m)  # no extra rank folds into us
        if self.folded[i]:
            self._send_round(eng, i, t)
        self._advance(eng, i, t)

    def _send_round(self, eng: AsyncEngine, i: int, t: float) -> None:
        r_idx = self.members.index(i)
        rnd = self.rnd[i]
        eng.send(
            Msg(src=i, dst=self.members[r_idx ^ (1 << rnd)], kind="rdub",
                payload=(self.generation, self.epoch[i], rnd,
                         self.partial[i])),
            t,
        )

    def on_message(self, eng: AsyncEngine, msg: Msg, t: float) -> None:
        if msg.kind != "rdub" or eng.detect_time is not None:
            return
        gen, e, r, val = msg.payload
        if int(gen) != self.generation:
            return  # pre-membership-change straggler: geometry is gone
        i = msg.dst
        if int(r) == self.RESULT:
            # epoch total delivered back to an extra (folded-in) rank:
            # decide independently, like every butterfly participant
            if int(e) != self.epoch[i]:
                return
            g = combine_contributions([float(val)], self.ord)
            if g < self.eps:
                eng.terminate(t, g)
            else:
                self.epoch[i] += 1
                self._begin_epoch(eng, i, t)
            return
        self.pending[i][(int(e), int(r))] = float(val)
        self._advance(eng, i, t)

    def _advance(self, eng: AsyncEngine, i: int, t: float) -> None:
        if not self.folded[i]:
            val = self.pending[i].pop((self.epoch[i], self.FOLD), None)
            if val is None:
                return
            self.partial[i] = self._acc(self.partial[i], val)
            self.folded[i] = True
            self._send_round(eng, i, t)  # round 0 waits for the fold
        while eng.detect_time is None:
            m, q, rounds, rem = self._geom
            val = self.pending[i].pop((self.epoch[i], self.rnd[i]), None)
            if val is None:
                return
            self.partial[i] = self._acc(self.partial[i], val)
            self.rnd[i] += 1
            if self.rnd[i] < rounds:
                self._send_round(eng, i, t)
                continue
            # epoch complete: every worker holds the global sum and decides
            r_idx = self.members.index(i)
            if r_idx < rem:
                eng.send(
                    Msg(src=i, dst=self.members[r_idx + q], kind="rdub",
                        payload=(self.generation, self.epoch[i], self.RESULT,
                                 self.partial[i])),
                    t,
                )
            g = combine_contributions([self.partial[i]], self.ord)
            if g < self.eps:
                eng.terminate(t, g)
                return
            self.epoch[i] += 1
            self._begin_epoch(eng, i, t)
            return


# ---------------------------------------------------------------------------
# NFAIS2 — snapshot carrying interface data (consistent records)
# ---------------------------------------------------------------------------


class NFAIS2(BaseProtocol):
    """On local convergence: record own component, send snapshot messages
    *containing the interface data* (protocol 2 of [12], after [15]).

    The recorded global vector is consistent by construction, so the reduced
    residual equals r(x̄_snapshot) exactly — at the cost of O(interface)
    snapshot bytes.
    """

    name = "nfais2"
    claim = "recorded"

    def __init__(self, eps: float, ord: float = 2.0):
        super().__init__(eps, ord)
        self.round = 0
        self._reset_round_state = True

    def recorded_vector(self):
        active = getattr(self, "_active", None)
        if active is None:
            active = [True] * len(self.rec_own)
        if any(self.rec_own[i] is None
               for i in range(len(self.rec_own)) if active[i]):
            return None
        # holes (None) are workers outside the membership — the oracle
        # substitutes their frozen live blocks (boundary data, not claims)
        return list(self.rec_own)

    def on_start(self, eng: AsyncEngine, t: float) -> None:
        p = eng.p
        self.rec_own: List[Optional[torch.Tensor]] = [None] * p
        self.rec_deps: List[Dict[int, torch.Tensor]] = [dict() for _ in range(p)]
        self._active = list(eng.active)
        self._reducing = False

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        # any membership change invalidates the round: a quorum over the
        # old member set would certify a system that no longer exists
        self._active = list(eng.active)
        self._new_round()

    def _new_round(self) -> None:
        self.round += 1
        for i in range(len(self.rec_own)):
            self.rec_own[i] = None
            self.rec_deps[i] = dict()
        self._reducing = False

    def wants_residual(self, eng: AsyncEngine, i: int) -> bool:
        return self.rec_own[i] is None  # recorded workers stop checking r_i

    def on_iteration(self, eng: AsyncEngine, i: int, t: float, r_i: float) -> None:
        if eng.detect_time is not None:
            return
        if r_i < self.eps and self.rec_own[i] is None:
            self.rec_own[i] = eng.x[i].clone()
            for j in eng.problem.neighbors(i):
                eng.send(
                    Msg(src=i, dst=j, kind="snap2",
                        payload=eng.problem.interface(i, eng.x[i], j),
                        round=self.round),
                    t,
                )
            self._maybe_reduce(eng, t)

    def on_message(self, eng: AsyncEngine, msg: Msg, t: float) -> None:
        if msg.kind != "snap2" or msg.round != self.round:
            return
        self.rec_deps[msg.dst][msg.src] = msg.payload
        self._maybe_reduce(eng, t)

    def _ready(self, eng: AsyncEngine, i: int) -> bool:
        # a snapshot message can only ever arrive from an *active*
        # neighbour; a crashed one's interface is frozen boundary data,
        # merged at reduce time (_record_deps_with_boundary)
        return self.rec_own[i] is not None and all(
            j in self.rec_deps[i] or not eng.active[j]
            for j in eng.problem.neighbors(i)
        )

    def _maybe_reduce(self, eng: AsyncEngine, t: float) -> None:
        if self._reducing or eng.detect_time is not None:
            return
        members = eng.active_workers()
        if not members or not all(self._ready(eng, i) for i in members):
            return
        self._reducing = True
        contribs = np.array(
            [
                self._record_residual(eng, i, self.rec_own[i],
                                      self._record_deps_with_boundary(eng, i))
                for i in members
            ]
        )
        eng.reductions_started += 1
        g = combine_contributions(contribs, self.ord)
        tc = t + self._reduce_latency(eng)
        rnd = self.round

        def complete(tt: float) -> None:
            if self.round != rnd:
                return  # membership change invalidated this quorum mid-reduce
            if g < self.eps:
                eng.terminate(tt, g)
            else:
                self._new_round()

        eng.schedule(tc, "callback", complete)


# ---------------------------------------------------------------------------
# NFAIS5 — approximate snapshot, empty messages + confirmation (O(1) bytes)
# ---------------------------------------------------------------------------


class NFAIS5(BaseProtocol):
    """Protocol 5 of [12]: local convergence persisting m iterations triggers
    an *empty* snapshot message; receivers record the last-delivered
    dependency on that link; a confirmation after m further iterations
    validates that local convergence persisted.  Records are only
    approximately consistent — residual guaranteed up to (1+c(p,m))ε."""

    name = "nfais5"

    def __init__(self, eps: float, ord: float = 2.0, m: int = 4):
        super().__init__(eps, ord)
        self.m = int(m)
        self.round = 0

    def on_start(self, eng: AsyncEngine, t: float) -> None:
        p = eng.p
        self.rec_own: List[Optional[torch.Tensor]] = [None] * p
        self.rec_deps: List[Dict[int, torch.Tensor]] = [dict() for _ in range(p)]
        self.consec = np.zeros(p, dtype=np.int64)   # consecutive sub-ε sweeps
        self.supp = np.full(p, -1, dtype=np.int64)  # supplementary counter
        self.confirmed = np.zeros(p, dtype=bool)
        self._active = list(eng.active)
        self._reducing = False

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        self._active = list(eng.active)
        self._new_round()

    def _new_round(self) -> None:
        self.round += 1
        p = len(self.rec_own)
        for i in range(p):
            self.rec_own[i] = None
            self.rec_deps[i] = dict()
        self.supp[:] = -1
        self.confirmed[:] = False
        # Require m *fresh* sub-ε sweeps before re-recording: confirmed
        # workers stop evaluating r_i (wants_residual), so their counter is
        # frozen — carrying it into the next round would let a worker
        # re-record off stale persistence.
        self.consec[:] = 0
        self._reducing = False

    def wants_residual(self, eng: AsyncEngine, i: int) -> bool:
        # confirmed workers are done checking local convergence this round
        return not (self.rec_own[i] is not None and self.confirmed[i])

    def on_iteration(self, eng: AsyncEngine, i: int, t: float, r_i: float) -> None:
        if eng.detect_time is not None:
            return
        if math.isnan(r_i):
            return  # skipped evaluation (wants_residual was False): freeze
        below = r_i < self.eps
        self.consec[i] = self.consec[i] + 1 if below else 0

        if not below and self.rec_own[i] is not None and not self.confirmed[i]:
            # convergence lost inside the confirmation window → snapshot invalid
            for j in eng.problem.neighbors(i):
                eng.send(Msg(src=i, dst=j, kind="confirm5", payload=False,
                             round=self.round), t)
            self._new_round()
            return

        if self.rec_own[i] is None and self.consec[i] >= self.m:
            # record + empty snapshot messages
            self.rec_own[i] = eng.x[i].clone()
            self.supp[i] = 0
            for j in eng.problem.neighbors(i):
                eng.send(Msg(src=i, dst=j, kind="snap5", round=self.round), t)
            self._maybe_reduce(eng, t)
        elif self.rec_own[i] is not None and not self.confirmed[i]:
            self.supp[i] += 1
            if self.supp[i] >= self.m:
                # persistent → confirm
                self.confirmed[i] = True
                for j in eng.problem.neighbors(i):
                    eng.send(Msg(src=i, dst=j, kind="confirm5", payload=True,
                                 round=self.round), t)
                self._maybe_reduce(eng, t)

    def on_message(self, eng: AsyncEngine, msg: Msg, t: float) -> None:
        if msg.round != self.round:
            return
        if msg.kind == "snap5":
            dep = eng.deps[msg.dst].get(msg.src)
            if dep is not None:
                self.rec_deps[msg.dst][msg.src] = dep.clone()
            self._maybe_reduce(eng, t)
        elif msg.kind == "confirm5" and msg.payload is False:
            if self.round == msg.round:
                self._new_round()

    def _ready(self, eng: AsyncEngine, i: int) -> bool:
        return (
            self.rec_own[i] is not None
            and self.confirmed[i]
            and all(j in self.rec_deps[i] or not eng.active[j]
                    for j in eng.problem.neighbors(i))
        )

    def _maybe_reduce(self, eng: AsyncEngine, t: float) -> None:
        if self._reducing or eng.detect_time is not None:
            return
        members = eng.active_workers()
        if not members or not all(self._ready(eng, i) for i in members):
            return
        self._reducing = True
        contribs = np.array(
            [
                self._record_residual(eng, i, self.rec_own[i],
                                      self._record_deps_with_boundary(eng, i))
                for i in members
            ]
        )
        eng.reductions_started += 1
        g = combine_contributions(contribs, self.ord)
        tc = t + self._reduce_latency(eng)
        rnd = self.round

        def complete(tt: float) -> None:
            if self.round != rnd:
                return  # membership change invalidated this quorum mid-reduce
            if g < self.eps:
                eng.terminate(tt, g)
            else:
                self._new_round()

        eng.schedule(tc, "callback", complete)


# ---------------------------------------------------------------------------
# Exact snapshot over FIFO channels (Chandy–Lamport markers)
# ---------------------------------------------------------------------------


class ExactSnapshotFIFO(BaseProtocol):
    """Marker-based snapshot [6] adapted to asynchronous iterations [12]:
    record on local convergence OR first marker of the round; on marker
    reception record the last dependency delivered on that link.  FIFO
    delivery makes the cut consistent → the reduced residual is exact."""

    name = "exact_snapshot"
    claim = "recorded"

    def __init__(self, eps: float, ord: float = 2.0):
        super().__init__(eps, ord)
        self.round = 0

    def recorded_vector(self):
        active = getattr(self, "_active", None)
        if active is None:
            active = [True] * len(self.rec_own)
        if any(self.rec_own[i] is None
               for i in range(len(self.rec_own)) if active[i]):
            return None
        return list(self.rec_own)

    def on_start(self, eng: AsyncEngine, t: float) -> None:
        if not eng.cfg.fifo:
            raise ValueError("ExactSnapshotFIFO requires cfg.fifo=True")
        p = eng.p
        self.rec_own: List[Optional[torch.Tensor]] = [None] * p
        self.rec_deps: List[Dict[int, torch.Tensor]] = [dict() for _ in range(p)]
        self._active = list(eng.active)
        self._reducing = False

    def on_membership(self, eng: AsyncEngine, t: float, kind: str,
                      worker: int) -> None:
        self._active = list(eng.active)
        self._new_round()

    def _new_round(self) -> None:
        self.round += 1
        for i in range(len(self.rec_own)):
            self.rec_own[i] = None
            self.rec_deps[i] = dict()
        self._reducing = False

    def _record_and_mark(self, eng: AsyncEngine, i: int, t: float) -> None:
        self.rec_own[i] = eng.x[i].clone()
        for j in eng.problem.neighbors(i):
            eng.send(Msg(src=i, dst=j, kind="marker", round=self.round), t)

    def wants_residual(self, eng: AsyncEngine, i: int) -> bool:
        return self.rec_own[i] is None

    def on_iteration(self, eng: AsyncEngine, i: int, t: float, r_i: float) -> None:
        if eng.detect_time is not None:
            return
        if r_i < self.eps and self.rec_own[i] is None:
            self._record_and_mark(eng, i, t)
            self._maybe_reduce(eng, t)

    def on_message(self, eng: AsyncEngine, msg: Msg, t: float) -> None:
        if msg.kind != "marker" or msg.round != self.round:
            return
        i = msg.dst
        if self.rec_own[i] is None:
            self._record_and_mark(eng, i, t)
        dep = eng.deps[i].get(msg.src)
        if dep is not None:
            self.rec_deps[i][msg.src] = dep.clone()
        self._maybe_reduce(eng, t)

    def _ready(self, eng: AsyncEngine, i: int) -> bool:
        return self.rec_own[i] is not None and all(
            j in self.rec_deps[i] or not eng.active[j]
            for j in eng.problem.neighbors(i)
        )

    def _maybe_reduce(self, eng: AsyncEngine, t: float) -> None:
        if self._reducing or eng.detect_time is not None:
            return
        members = eng.active_workers()
        if not members or not all(self._ready(eng, i) for i in members):
            return
        self._reducing = True
        contribs = np.array(
            [
                self._record_residual(eng, i, self.rec_own[i],
                                      self._record_deps_with_boundary(eng, i))
                for i in members
            ]
        )
        eng.reductions_started += 1
        g = combine_contributions(contribs, self.ord)
        tc = t + self._reduce_latency(eng)
        rnd = self.round

        def complete(tt: float) -> None:
            if self.round != rnd:
                return  # membership change invalidated this quorum mid-reduce
            if g < self.eps:
                eng.terminate(tt, g)
            else:
                self._new_round()

        eng.schedule(tc, "callback", complete)


PROTOCOLS = {
    "pfait": PFAIT,
    "rdub": RecursiveDoublingProtocol,
    "nfais2": NFAIS2,
    "nfais5": NFAIS5,
    "exact_snapshot": ExactSnapshotFIFO,
}
