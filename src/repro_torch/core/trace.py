"""Structured event traces (schema ``repro-trace/1``), serialized to JSONL.

A trace is a header plus a flat event list.  Serialized as JSONL: line 1
is the header object, every further line one event object.  Events carry
four fixed keys plus free scalar payload fields::

    {"kind": <EVENT_KINDS>, "t": float, "w": int worker (-1 global),
     "step": int iteration/round (-1 n/a), ...payload}

Kinds: ``sweep`` (one local sweep batch), ``halo`` (interface exchange),
``reduce`` (reduction round; payload ``residual`` carries the launched
global value), ``detect`` (detection claim), ``member`` (membership
change), ``segment`` (device wall segment), ``finish``.

This is the port's copy of the JAX package's schema (``core/trace.py``):
a trace the port writes is text that the JAX package's ``Trace.loads``
reads and validates unchanged, and that its replay and calibration
(``sim/replay.py``, ``sim/calibrate.py``, and the port's own copies)
accept.  ``EngineTraceObserver`` records an event-engine run
(``core/async_engine.py``) with the engine's virtual timestamps.
``trace_from_shard_run``
(and ``trace_from_train_run``) turns a shard (training) run into a trace:
per-step timestamps stay the measured wall interpolated over the outer
steps, marked ``synthetic_t`` in the header; the loop's measured phase
times are its spans' (``core/spans.py``), which a trace does not carry.
``trace_from_elastic_report`` writes the
elastic driver's segments and membership events.
"""
from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.reduction import get_reduction
from repro_torch.runtime.shard_runtime import _per_shard
from repro_torch.solvers.partition import MeshPartition

SCHEMA = "repro-trace/1"

EVENT_KINDS = ("sweep", "halo", "reduce", "detect", "member", "segment",
               "finish")

_REQUIRED = ("kind", "t", "w", "step")


def event(kind: str, t: float, w: int = -1, step: int = -1,
          **payload: Any) -> Dict[str, Any]:
    """One schema event (validated at construction)."""
    if kind not in EVENT_KINDS:
        raise ValueError(f"event kind {kind!r} not in {EVENT_KINDS}")
    # payload keys cannot shadow the schema keys: they are named
    # parameters, so Python rejects duplicates before we see them
    ev = {"kind": kind, "t": float(t), "w": int(w), "step": int(step)}
    ev.update(payload)
    return ev


class Trace:
    """Header + event list; JSONL round-trip; content fingerprint."""

    def __init__(self, source: str, p: int,
                 meta: Optional[Dict[str, Any]] = None):
        self.header: Dict[str, Any] = {
            "schema": SCHEMA,
            "source": str(source),
            "p": int(p),
            "meta": dict(meta or {}),
        }
        self.events: List[Dict[str, Any]] = []

    # -- construction -------------------------------------------------------
    def append(self, ev: Dict[str, Any]) -> None:
        self.events.append(ev)

    def add(self, kind: str, t: float, w: int = -1, step: int = -1,
            **payload: Any) -> None:
        self.events.append(event(kind, t, w, step, **payload))

    # -- access -------------------------------------------------------------
    @property
    def p(self) -> int:
        return int(self.header["p"])

    @property
    def source(self) -> str:
        return str(self.header["source"])

    @property
    def meta(self) -> Dict[str, Any]:
        return self.header["meta"]

    def events_of(self, kind: str) -> List[Dict[str, Any]]:
        if kind not in EVENT_KINDS:
            raise ValueError(f"event kind {kind!r} not in {EVENT_KINDS}")
        return [e for e in self.events if e["kind"] == kind]

    def residual_series(self) -> List[float]:
        """Launched global-residual series indexed by outer step.

        Steps with no finite reduce value (e.g. recursive doubling's first
        log2(p)-1 rounds, before any butterfly epoch completes) hold +inf —
        the same "no value visible yet" convention as the runtime's ring.
        """
        ev = [e for e in self.events_of("reduce") if "residual" in e]
        if not ev:
            return []
        n = max(e["step"] for e in ev) + 1
        out = [float("inf")] * n
        for e in ev:
            if e["step"] >= 0:
                out[e["step"]] = float(e["residual"])
        return out

    # -- serialization ------------------------------------------------------
    def dumps(self) -> str:
        lines = [json.dumps(self.header, sort_keys=True)]
        lines += [json.dumps(e, sort_keys=True) for e in self.events]
        return "\n".join(lines) + "\n"

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def loads(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace")
        header = json.loads(lines[0])
        if header.get("schema") != SCHEMA:
            raise ValueError(
                f"unknown trace schema {header.get('schema')!r} "
                f"(expected {SCHEMA!r})")
        tr = cls(header.get("source", "?"), header.get("p", 0),
                 header.get("meta"))
        tr.header = header
        tr.events = [json.loads(ln) for ln in lines[1:]]
        return tr

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls.loads(f.read())

    def fingerprint(self) -> str:
        """Deterministic digest of header + events (replay identity)."""
        h = hashlib.sha256()
        h.update(json.dumps(self.header, sort_keys=True).encode())
        for e in self.events:
            h.update(json.dumps(e, sort_keys=True).encode())
        return h.hexdigest()

    def validate(self) -> None:
        """Raise ValueError on the first schema violation."""
        if self.header.get("schema") != SCHEMA:
            raise ValueError(f"bad schema {self.header.get('schema')!r}")
        if not isinstance(self.header.get("p"), int) or self.header["p"] < 1:
            raise ValueError(f"bad worker count p={self.header.get('p')!r}")
        if "source" not in self.header:
            raise ValueError("header missing 'source'")
        for i, e in enumerate(self.events):
            for k in _REQUIRED:
                if k not in e:
                    raise ValueError(f"event {i} missing key {k!r}: {e}")
            if e["kind"] not in EVENT_KINDS:
                raise ValueError(f"event {i} kind {e['kind']!r} unknown")
            if not isinstance(e["w"], int) or not isinstance(e["step"], int):
                raise ValueError(f"event {i} w/step must be int: {e}")
            t = e["t"]
            if not isinstance(t, (int, float)) or t != t:
                raise ValueError(f"event {i} bad timestamp {t!r}")


def validate_trace(tr: Trace) -> bool:
    """Boolean form of ``Trace.validate``."""
    try:
        tr.validate()
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# Event-engine emitter (AsyncEngine observer)
# ---------------------------------------------------------------------------


class EngineTraceObserver:
    """``AsyncEngine(..., recorder=)`` observer emitting schema events.

    Same hook protocol as ``core.reliability.TraceRecorder`` (the engine
    feature-detects ``record_sends`` exactly the same way), but the output
    is a schema ``Trace``.  Timestamps are the engine's own virtual clock.
    """

    def __init__(self, p: int, record_sends: bool = True,
                 meta: Optional[Dict[str, Any]] = None):
        self.record_sends = bool(record_sends)
        self.trace = Trace("engine", p, meta)

    # -- engine hooks -------------------------------------------------------
    def on_sweep(self, eng, t: float, i: int) -> None:
        self.trace.add("sweep", t, w=i, step=int(eng.k[i]))

    def on_send(self, eng, msg, t: float, deliver) -> None:
        kind = "halo" if msg.kind == "data" else "reduce"
        self.trace.add(kind, t, w=int(msg.src), step=int(msg.round),
                       dst=int(msg.dst), msg=str(msg.kind),
                       deliver=(None if deliver is None else float(deliver)),
                       dropped=deliver is None)

    def on_membership(self, eng, t: float, kind: str, worker: int) -> None:
        self.trace.add("member", t, w=int(worker), change=str(kind))

    def on_detect(self, eng, t: float, detected: float) -> None:
        self.trace.add("detect", t, residual=float(detected))

    def on_finish(self, eng, result) -> None:
        self.trace.add("finish", float(eng.now),
                       terminated=bool(result.terminated),
                       k_max=int(result.k_max), k_min=int(result.k_min))


# ---------------------------------------------------------------------------
# Shard-runtime adapter
# ---------------------------------------------------------------------------


def _series_prefix(trace_arr, limit: int) -> List[float]:
    """Raw launched-residual prefix, step-indexed (non-finite kept); a
    tensor is read from its device."""
    if isinstance(trace_arr, torch.Tensor):
        trace_arr = trace_arr.detach().cpu().numpy()
    arr = np.asarray(trace_arr, dtype=np.float64)[:max(limit, 0)]
    return [float(v) for v in arr]


def trace_from_shard_run(result, cfg, p: int, wall_s: float,
                         source: str = "shard",
                         meta: Optional[Dict[str, Any]] = None) -> Trace:
    """Schema trace of one shard or training run.

    ``result`` — a ``ShardRunResult`` or ``TrainRunResult``; ``cfg`` the
    ``ShardRuntimeConfig`` or ``TrainAsyncConfig`` it ran under.  Per-step
    timestamps are the measured wall interpolated uniformly over the outer
    steps — ``synthetic_t`` marks them.
    """
    outer = int(getattr(result, "outer_iters", getattr(result, "rounds", 0)))
    tlen = int(cfg.trace_len)
    series = _series_prefix(result.trace, min(outer, max(tlen, 1)))
    mode = get_reduction(cfg.reduction)
    mon = cfg.effective_monitor()
    inner_field = getattr(cfg, "inner_sweeps", getattr(cfg, "inner_steps", 1))
    delay_field = getattr(cfg, "halo_delay", getattr(cfg, "view_delay", 0))
    inner = _per_shard(inner_field, p, "inner").tolist()
    delay = _per_shard(delay_field, p, "delay").tolist()
    lag = _per_shard(cfg.contrib_lag, p, "contrib_lag").tolist()
    mesh_shape = tuple(getattr(cfg, "mesh_shape", None) or (p,))
    # per-worker exchanged faces ((label, peer) pairs) on multi-axis meshes —
    # the 1-D pencil keeps a single halo event per worker
    faces: List[List] = [[] for _ in range(p)]
    if len(mesh_shape) > 1:
        # face topology is n-independent; any n each axis divides will do
        part = MeshPartition(math.lcm(*mesh_shape), mesh_shape)
        faces = [[(part.face(w, j), j) for j in part.neighbors(w)]
                 for w in range(p)]
    header_meta = {
        "reduction": cfg.reduction,
        "topology": mode.topology,
        "mesh_shape": list(mesh_shape),
        "monitor": {
            "mode": mon.mode, "eps": float(mon.eps),
            "eps_tilde": float(mon.eps_tilde),
            "staleness": int(mon.staleness),
            "persistence": int(mon.persistence), "ord": float(mon.ord),
            "check_every": 1,   # the port's monitor checks every step
        },
        "inner_sweeps": inner,
        "halo_delay": delay,
        "contrib_lag": lag,
        "wall_s": float(wall_s),
        "outer_iters": outer,
        "converged": bool(result.converged),
        "synthetic_t": True,
    }
    header_meta.update(meta or {})
    tr = Trace(source, p, header_meta)
    steps = len(series)
    dt = float(wall_s) / max(outer, 1)
    rpv = mode.rounds_per_value(p)
    for k in range(steps):
        t = (k + 1) * dt
        for w in range(p):
            tr.add("sweep", t, w=w, step=k, inner=inner[w])
            if faces[w]:
                for label, peer in faces[w]:
                    tr.add("halo", t, w=w, step=k, delay=delay[w],
                           face=label, peer=peer)
            else:
                tr.add("halo", t, w=w, step=k, delay=delay[w])
        if np.isfinite(series[k]):
            tr.add("reduce", t, step=k, residual=series[k], lag=max(lag),
                   rounds_per_value=rpv)
    if bool(result.converged) and outer > 0:
        tr.add("detect", wall_s, step=outer - 1,
               residual=float(result.residual))
    tr.add("finish", wall_s, step=max(outer - 1, -1),
           terminated=bool(result.converged))
    return tr


def trace_from_train_run(result, cfg, p: int, wall_s: float,
                         meta: Optional[Dict[str, Any]] = None) -> Trace:
    """``trace_from_shard_run`` for the data-parallel training loop."""
    return trace_from_shard_run(result, cfg, p, wall_s, source="train",
                                meta=meta)


def trace_from_elastic_report(report, cfg, p0: int,
                              segment_walls: Optional[Iterable[float]] = None,
                              meta: Optional[Dict[str, Any]] = None) -> Trace:
    """Segment-level trace of the elastic control loop.

    Segment boundaries and membership events are real (host-side) control
    plane observations; ``segment_walls`` (per-segment wall seconds, when
    the driver measured them) become the segment timestamps, else the
    virtual one-unit-per-segment clock is used.
    """
    walls = list(segment_walls or [])
    header_meta = {
        "reduction": cfg.reduction,
        "segments_run": int(report.segments_run),
        "restarts": int(report.restarts),
        "stall_segments": int(report.stall_segments),
        "converged": bool(report.converged),
        "mesh_history": [[int(s), int(pc)] for s, pc in report.mesh_history],
        "synthetic_t": not walls,
    }
    header_meta.update(meta or {})
    tr = Trace("elastic", p0, header_meta)

    def t_of(seg: int) -> float:
        if walls:
            return float(sum(walls[:seg + 1]))
        return float(seg + 1)

    for seg in range(int(report.segments_run)):
        tr.add("segment", t_of(seg), step=seg,
               wall_s=(walls[seg] if seg < len(walls) else 1.0))
    for seg, kind, detail in report.events:
        if kind in ("crash", "join", "restart"):
            tr.add("member", t_of(int(seg)), step=int(seg),
                   change=str(kind), detail=str(detail))
        elif kind == "detect":
            tr.add("detect", t_of(int(seg)), step=int(seg),
                   residual=(float(report.detected_residual)
                             if report.detected_residual is not None
                             else None))
    tr.add("finish", t_of(int(report.segments_run) - 1),
           step=int(report.segments_run) - 1,
           terminated=bool(report.converged))
    return tr
