"""Process-wide metrics registry — Counter / Gauge / Histogram families with
label sets.

The reference builds its operator/memory summary tables post-hoc from profiler
records (python/paddle/profiler/profiler_statistic.py); a serving runtime needs
the same aggregates LIVE (TTFT distributions, queue depth, retrace storms), so
this module keeps them as mutable families that render to a JSON snapshot or
Prometheus text exposition on demand.

Design rules:

- One process-wide switch (:func:`enable` / :func:`disable`). Every mutation
  checks it first, so an instrumented binary with metrics off pays one module
  global read + one branch per call site — and the dispatch hot path pays
  NOTHING, because core/dispatch.py only carries a recorder in its single
  instrumentation slot while metrics are on.
- A family is created once (``registry.counter(name, help, labelnames)``) and
  cached by name; re-creating with a different type or label set is an error.
  Children ("series") are keyed by label values; hot call sites bind a child
  once (``family.labels(engine="0")``) and call ``.inc()/.observe()`` on it.
- Correctness under threads comes from a per-family lock around every
  read-modify-write (incrementing a Python float under the GIL alone is NOT
  atomic), taken only while metrics are enabled.
- :meth:`MetricsRegistry.reset` zeroes values IN PLACE: children bound before
  a reset stay valid, so test isolation never invalidates live handles.
"""
from __future__ import annotations

import bisect
import re
import threading

__all__ = ["MetricsRegistry", "REGISTRY", "enabled", "DEFAULT_BUCKETS",
           "render_snapshot", "merge_snapshots"]

_ENABLED = False


def enabled() -> bool:
    """Is the process-wide telemetry switch on?"""
    return _ENABLED


def _set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus client defaults, extended downward: dispatch/token latencies on a
# local runtime sit well under a millisecond.
DEFAULT_BUCKETS = (
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    # HELP text escapes only backslash and newline (0.0.4 exposition spec)
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(v) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


class _Family:
    """Base: a named metric with a fixed label schema and one lock."""

    kind = ""

    def __init__(self, name, help="", labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def labels(self, **labelvalues):
        """Bind (and memoize) the child for one label-value set."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._series.get(key)
            if child is None:
                child = self._series[key] = self._child_cls(self._lock)
        return child

    def _snapshot(self):
        with self._lock:
            return {
                "type": self.kind,
                "help": self.help,
                "series": [
                    {"labels": dict(zip(self.labelnames, key)),
                     **child._data()}
                    for key, child in sorted(self._series.items())
                ],
            }

    def _reset(self):
        with self._lock:
            for child in self._series.values():
                child._zero()


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, n=1):
        if not _ENABLED:
            return
        if n < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self.value += n

    def _data(self):
        return {"value": self.value}

    def _zero(self):
        self.value = 0.0


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v):
        if not _ENABLED:
            return
        with self._lock:
            self.value = float(v)

    def inc(self, n=1):
        if not _ENABLED:
            return
        with self._lock:
            self.value += n

    def dec(self, n=1):
        self.inc(-n)

    def _data(self):
        return {"value": self.value}

    def _zero(self):
        self.value = 0.0


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    # bounds injected per-family by HistogramFamily.labels (slot shared setup)
    def __init__(self, lock, bounds=()):
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        if not _ENABLED:
            return
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)   # le bounds are inclusive
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def _data(self):
        # raw (non-cumulative) per-bucket counts; rendering cumulates
        return {"buckets": dict(zip([*map(_fmt, self.bounds), "+Inf"],
                                    self.counts)),
                "sum": self.sum, "count": self.count}

    def _zero(self):
        self.counts = [0] * len(self.counts)
        self.sum = 0.0
        self.count = 0


class CounterFamily(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n=1, **labelvalues):
        if not _ENABLED:
            return
        self.labels(**labelvalues).inc(n)


class GaugeFamily(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v, **labelvalues):
        if not _ENABLED:
            return
        self.labels(**labelvalues).set(v)

    def inc(self, n=1, **labelvalues):
        if not _ENABLED:
            return
        self.labels(**labelvalues).inc(n)


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"{name}: buckets must be distinct and sorted")
        self.buckets = b

    def _child_cls(self, lock):
        return _HistogramChild(lock, self.buckets)

    def observe(self, v, **labelvalues):
        if not _ENABLED:
            return
        self.labels(**labelvalues).observe(v)


class MetricsRegistry:
    """Name -> family map with snapshot / Prometheus rendering."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _family(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, labelnames, **kw)
            elif type(fam) is not cls or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind} with labels "
                    f"{tuple(labelnames)}; existing: {fam.kind} "
                    f"{fam.labelnames}")
            return fam

    def counter(self, name, help="", labelnames=()) -> CounterFamily:
        return self._family(CounterFamily, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> GaugeFamily:
        return self._family(GaugeFamily, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> HistogramFamily:
        return self._family(HistogramFamily, name, help, labelnames,
                            buckets=buckets)

    def snapshot(self, prefix=None, labels=None) -> dict:
        """JSON-able dump: {metric: {type, help, series: [{labels, ...}]}}.

        prefix: keep only metric names starting with it.
        labels: keep only series whose label dict CONTAINS these pairs.
        """
        with self._lock:
            fams = sorted(self._families.items())
        out = {}
        for name, fam in fams:
            if prefix and not name.startswith(prefix):
                continue
            snap = fam._snapshot()
            if labels:
                snap["series"] = [
                    s for s in snap["series"]
                    if all(s["labels"].get(k) == str(v)
                           for k, v in labels.items())]
            out[name] = snap
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family."""
        return render_snapshot(self.snapshot())

    def reset(self):
        """Zero every series in place (live children stay bound)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            fam._reset()


def render_snapshot(snap: dict) -> str:
    """Prometheus text exposition (version 0.0.4) of a snapshot dict — the
    single render path for both a live registry and federated (merged)
    remote snapshots, so escaping and histogram framing can't drift."""
    lines = []
    for name, fam in snap.items():
        if fam["help"]:
            lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam["series"]:
            lbl = ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in s["labels"].items())
            if fam["type"] == "histogram":
                acc = 0
                for le, n in s["buckets"].items():
                    acc += n
                    sep = "," if lbl else ""
                    lines.append(
                        f'{name}_bucket{{{lbl}{sep}le="{le}"}} {acc}')
                brace = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}_sum{brace} {_fmt(s['sum'])}")
                lines.append(f"{name}_count{brace} {s['count']}")
            else:
                brace = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}{brace} {_fmt(s['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def merge_snapshots(local: dict, remotes: dict) -> dict:
    """Fold remote registry snapshots into one exposition-ready dict for
    the gateway's federated ``/metrics``.

    ``remotes`` maps a replica name to that worker's full ``snapshot()``.
    Remote series are relabeled with ``replica=<name>`` — unless the series
    already carries a ``replica`` label (the front-door families do), so a
    worker's own attribution is never overwritten.  Local series pass
    through untouched.  A remote family whose type conflicts with an
    already-merged one is skipped (first writer wins) rather than emitting
    an exposition the scraper would reject.
    """
    out = {}
    for name, fam in local.items():
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "series": list(fam["series"])}
    for replica, snap in sorted(remotes.items()):
        for name, fam in snap.items():
            dst = out.get(name)
            if dst is None:
                dst = out[name] = {"type": fam["type"], "help": fam["help"],
                                   "series": []}
            elif dst["type"] != fam["type"]:
                continue
            for s in fam["series"]:
                labels = dict(s["labels"])
                if "replica" not in labels:
                    labels["replica"] = str(replica)
                dst["series"].append({**s, "labels": labels})
    return out


REGISTRY = MetricsRegistry()
