"""Cross-process request tracing: trace contexts, a bounded per-process
flight recorder, and chrome-trace export/merge.

The metrics registry answers "how is the fleet doing"; this module answers
"where did request X spend its time" after that request crossed three
process boundaries (gateway -> RPC worker -> disagg pool).  Three pieces:

- :class:`TraceContext` — a trace id plus a Lamport clock stamp.  The
  gateway mints one per request (or adopts the client's ``X-Request-ID``);
  it crosses the worker RPC plane as a tiny picklable tuple
  (:func:`wire_context` / :func:`adopt_wire`), and inside a process it
  travels ambiently in a :mod:`contextvars` variable so deep call stacks
  (``gateway -> ReplicaSet.submit -> engine.add_request``) never need a
  threaded-through parameter.  The clock is process-global and ticks on
  every recorded event; a receiver folds the sender's stamp in with
  ``max(local, received) + 1``, so event ``lamport`` values are monotone
  along every causal chain even though processes share no wall clock.

- the flight recorder — a bounded ring (``deque(maxlen=...)``) of span
  events.  Disabled (the default) every :func:`record` call returns after
  one module-global flag check; enabled, an event is a small dict appended
  under one lock.  :func:`pin` copies a trace's events into a non-evictable
  store — anomaly paths (stuck step, quarantine, resume, handoff poison)
  pin their victim so the evidence survives ring churn — and, when a dump
  directory is configured (``PADDLE_TPU_TRACE_DUMP_DIR`` or
  :func:`configure`), writes the pinned trace as a chrome-trace JSON file
  via the journal's atomic tmp + ``os.replace`` idiom.

- export/merge — :func:`merge_events` orders events from any number of
  process-local recorders by Lamport stamp, and :func:`chrome_trace`
  renders the merged list as a ``chrome://tracing`` / Perfetto-loadable
  JSON object (one chrome "process" per recorder label, with
  ``process_name`` metadata events).

Events are plain dicts so a worker can ship them over the RPC plane
(``trace_events`` op) with no extra serialization support.
"""
from __future__ import annotations

import contextvars
import hashlib
import json
import os
import re
import threading
import time
import uuid
from collections import deque

__all__ = [
    "TraceContext", "mint", "current", "use_context", "wire_context",
    "adopt_wire", "set_proc_label", "enable", "disable", "enabled",
    "configure", "record", "pin", "pin_rid", "events_for", "trace_for_rid",
    "snapshot_events", "pinned", "merge_events", "chrome_trace",
    "dump_trace", "reset",
]

_ENABLED = False

# process-global Lamport clock: ticks on every recorded event and on every
# context send/receive, folds received stamps in with max()+1
_clock_lock = threading.Lock()
_clock = 0


def _tick() -> int:
    global _clock
    with _clock_lock:
        _clock += 1
        return _clock


def _adopt(received: int) -> int:
    global _clock
    with _clock_lock:
        if received > _clock:
            _clock = received
        _clock += 1
        return _clock


class TraceContext:
    """One request's trace identity: the trace id plus the Lamport stamp it
    last crossed a boundary with.  Cheap, immutable-ish, picklable."""

    __slots__ = ("trace_id", "clock")

    def __init__(self, trace_id, clock=0):
        self.trace_id = str(trace_id)
        self.clock = int(clock)

    def __getstate__(self):
        return (self.trace_id, self.clock)

    def __setstate__(self, state):
        self.trace_id, self.clock = state

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, clock={self.clock})"


_current: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_trace_ctx", default=None)
# per-thread/process display label for recorded events ("gateway", worker
# name, ...); contextvar so threaded test fleets get distinct labels
_proc_label: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_trace_proc", default=None)


# Trace ids become dump filenames (``trace-<id>.json`` under the dump dir),
# and the gateway adopts the client-supplied X-Request-ID as the id — so a
# hostile header must never smuggle path syntax into os.replace.
_SAFE_ID = re.compile(r"[A-Za-z0-9._-]{1,120}")


def _safe_trace_id(trace_id) -> str:
    """Allowlisted id verbatim; anything else (path separators, overlong,
    control bytes) is replaced by a stable hash of itself, so a hostile
    client still gets a usable — and still collision-resistant — trace id."""
    tid = str(trace_id)
    if _SAFE_ID.fullmatch(tid):
        return tid
    digest = hashlib.sha256(tid.encode("utf-8", "surrogatepass")).hexdigest()
    return f"h{digest[:16]}"


def mint(trace_id=None) -> TraceContext:
    """New context: adopt the caller-supplied id (``X-Request-ID``),
    sanitized for filesystem safety, or mint a fresh one."""
    if not trace_id:
        return TraceContext(uuid.uuid4().hex[:16], _tick())
    return TraceContext(_safe_trace_id(trace_id), _tick())


def current():
    """The ambient :class:`TraceContext`, or None outside a traced scope."""
    return _current.get()


class use_context:
    """Install ``ctx`` as the ambient trace context for a scope (``with
    use_context(ctx): ...``).  ``ctx=None`` is a no-op passthrough."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx is not None:
            self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._token is not None:
            _current.reset(self._token)
        return False


def wire_context():
    """The ambient context as a picklable ``(trace_id, clock)`` tuple for an
    RPC frame, ticking the clock (a send is an event) — or None when there
    is nothing to propagate."""
    ctx = _current.get()
    if ctx is None or not _ENABLED:
        return None
    return (ctx.trace_id, _tick())


def adopt_wire(wire):
    """Receiver half: fold the sender's Lamport stamp into the local clock
    and return a local :class:`TraceContext` (None for a None wire)."""
    if wire is None:
        return None
    trace_id, clock = wire
    return TraceContext(trace_id, _adopt(int(clock)))


def set_proc_label(label):
    """Name this thread's recorder events (worker name, "gateway", ...).
    Falls back to ``pid<os.getpid()>`` when never set."""
    _proc_label.set(str(label))


# --------------------------------------------------------- flight recorder
_DEFAULT_RING = 4096
_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=_DEFAULT_RING)
_pinned: dict = {}            # trace_id -> {"reason", "events": [...]}
_PINNED_MAX = 256             # oldest pin evicted past this (anomaly churn)
_rid_to_trace: dict = {}      # rid -> trace_id (bounded, insertion order)
_RID_MAP_MAX = 4096
_dump_dir = None              # configure() override; else env var


def enable() -> None:
    """Switch the flight recorder on (independent of the metrics switch, so
    the bench can pin trace overhead on its own)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def configure(ring_size=None, dump_dir=None) -> None:
    """Resize the ring (evicting from the old head) and/or set the anomaly
    dump directory (overrides ``PADDLE_TPU_TRACE_DUMP_DIR``)."""
    global _ring, _dump_dir
    if ring_size is not None:
        with _ring_lock:
            _ring = deque(_ring, maxlen=int(ring_size))
    if dump_dir is not None:
        _dump_dir = str(dump_dir)


def reset() -> None:
    """Drop every event, pin, and rid mapping (test isolation); the
    enable/disable switch and the Lamport clock are left untouched."""
    with _ring_lock:
        _ring.clear()
        _pinned.clear()
        _rid_to_trace.clear()


def record(phase, rid=None, trace_id=None, dur=None, **args) -> None:
    """Append one span event.  Disabled: one flag check.  Untraced (no
    explicit ``trace_id`` and no ambient context): a no-op — only requests
    that entered through a traced front door generate events."""
    if not _ENABLED:
        return
    if trace_id is None:
        ctx = _current.get()
        if ctx is None:
            return
        trace_id = ctx.trace_id
    ev = {
        "trace_id": trace_id,
        "phase": str(phase),
        "lamport": _tick(),
        # genuine wall clock: events from DIFFERENT processes merge on one
        # timeline, so the only shared clock is calendar time (causal order
        # still comes from the Lamport stamp, never from ts)
        "ts": time.time(),  # graftlint: disable=no-adhoc-telemetry
        "proc": _proc_label.get() or f"pid{os.getpid()}",
        "pid": os.getpid(),
    }
    if rid is not None:
        ev["rid"] = rid
    if dur is not None:
        ev["dur"] = float(dur)
    if args:
        ev["args"] = args
    with _ring_lock:
        _ring.append(ev)
        if rid is not None:
            if len(_rid_to_trace) >= _RID_MAP_MAX and rid not in _rid_to_trace:
                _rid_to_trace.pop(next(iter(_rid_to_trace)))
            _rid_to_trace[rid] = trace_id


def trace_for_rid(rid):
    """The trace id last recorded for ``rid`` in this process, or None."""
    return _rid_to_trace.get(rid)


def events_for(trace_id):
    """All events for one trace held in this process: pinned copy (if any)
    merged with whatever still lives in the ring, deduped by stamp."""
    with _ring_lock:
        ring = [e for e in _ring if e["trace_id"] == trace_id]
        pin = _pinned.get(trace_id)
        events = list(pin["events"]) if pin else []
    seen = {(e["lamport"], e["pid"]) for e in events}
    events += [e for e in ring if (e["lamport"], e["pid"]) not in seen]
    events.sort(key=lambda e: e["lamport"])
    return events


def snapshot_events(trace_id=None):
    """Picklable event list for the RPC pull: one trace's events, or (with
    ``trace_id=None``) the whole ring plus every pinned trace."""
    if trace_id is not None:
        return events_for(trace_id)
    with _ring_lock:
        events = list(_ring)
        extra = [e for pin in _pinned.values() for e in pin["events"]]
    seen = {(e["lamport"], e["pid"]) for e in events}
    events += [e for e in extra if (e["lamport"], e["pid"]) not in seen]
    events.sort(key=lambda e: e["lamport"])
    return events


def pinned():
    """{trace_id: reason} for every pinned trace in this process."""
    with _ring_lock:
        return {tid: pin["reason"] for tid, pin in _pinned.items()}


def pin(trace_id, reason) -> bool:
    """Copy a trace's events into the non-evictable store (anomaly capture)
    and, when a dump directory is configured, write the chrome-trace dump.
    Lock-ordering-safe from anywhere: takes only the recorder lock."""
    if not _ENABLED or trace_id is None:
        return False
    record("pinned", trace_id=trace_id, reason=str(reason))
    events = events_for(trace_id)
    with _ring_lock:
        # bounded like _rid_to_trace: replica churn pins every resumed
        # request, and a long-lived process must not leak anomaly captures —
        # past the cap the oldest pin falls out (its dump file, if any,
        # already made it to disk)
        if trace_id not in _pinned and len(_pinned) >= _PINNED_MAX:
            _pinned.pop(next(iter(_pinned)))
        _pinned[trace_id] = {"reason": str(reason), "events": events}
    d = _dump_dir or os.environ.get("PADDLE_TPU_TRACE_DUMP_DIR")
    if d:
        try:
            dump_trace(trace_id, events, reason=reason, out_dir=d)
        except OSError:
            pass             # post-mortem capture must never hurt serving
    return True


def pin_rid(rid, reason) -> bool:
    """Pin by engine/gateway request id (anomaly sites know the rid; the
    recorder remembers which trace it belonged to)."""
    return pin(_rid_to_trace.get(rid), reason)


def dump_trace(trace_id, events, reason=None, out_dir=None) -> str:
    """Write one trace as chrome-trace JSON, atomically (tmp +
    ``os.replace``, the journal idiom): readers never see a torn file, and
    a re-pin of the same trace replaces the dump in place."""
    d = out_dir or _dump_dir or os.environ.get("PADDLE_TPU_TRACE_DUMP_DIR")
    if not d:
        raise OSError("no trace dump directory configured")
    # mint() sanitizes every adopted id, but this is the write site: refuse
    # any id that could escape the dump dir rather than trust every caller
    if not _SAFE_ID.fullmatch(str(trace_id)):
        raise OSError(f"unsafe trace id for dump: {str(trace_id)!r}")
    os.makedirs(d, exist_ok=True)
    doc = chrome_trace(events)
    if reason is not None:
        doc["metadata"] = {"trace_id": trace_id, "pin_reason": str(reason)}
    path = os.path.join(d, f"trace-{trace_id}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


# ----------------------------------------------------------- export / merge
def merge_events(*event_lists):
    """Fold per-process event lists (local recorder + ``trace_events`` RPC
    pulls) into ONE causally-ordered list: dedup by (lamport, pid) — the
    same event can arrive via both the ring and a pinned copy — then sort
    by Lamport stamp, wall time breaking ties between concurrent events."""
    seen = set()
    merged = []
    for events in event_lists:
        for e in events or ():
            key = (e["lamport"], e.get("pid"), e.get("proc"))
            if key in seen:
                continue
            seen.add(key)
            merged.append(e)
    merged.sort(key=lambda e: (e["lamport"], e.get("ts", 0.0)))
    return merged


def chrome_trace(events) -> dict:
    """Render events as a chrome://tracing / Perfetto JSON object.  One
    chrome "process" per recorder label (named via ``process_name``
    metadata events); spans with a duration become complete events
    (``ph="X"``), the rest instants (``ph="i"``)."""
    procs = {}
    trace_events = []
    for e in events:
        label = e.get("proc", "?")
        pid = procs.get(label)
        if pid is None:
            pid = procs[label] = len(procs) + 1
            trace_events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": label}})
        ev = {
            "name": e["phase"],
            "cat": "serving",
            "pid": pid,
            "tid": int(e.get("rid", 0)) if str(e.get("rid", 0)).isdigit()
                   else 0,
            "ts": round(e.get("ts", 0.0) * 1e6, 3),
            "args": {k: v for k, v in e.items()
                     if k not in ("phase", "ts", "dur", "proc")},
        }
        dur = e.get("dur")
        if dur is not None:
            ev["ph"] = "X"
            ev["dur"] = round(float(dur) * 1e6, 3)
            # chrome renders complete events from their START; recorded ts
            # is the span end (measured after the work), so rebase
            ev["ts"] = round(max(0.0, e.get("ts", 0.0) - float(dur)) * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        trace_events.append(ev)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
