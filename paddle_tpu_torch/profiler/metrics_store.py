"""In-process metric time-series store — the SLO sensor substrate
(counterpart: ``paddle_tpu/profiler/metrics_store.py``, standard library
only, ported verbatim).

The serving telemetry (``serving_telemetry.py``) answers "what is the
state NOW" (point-in-time gauges, cumulative counters, all-time latency
histograms); the flight recorder answers "why was THIS token slow"
(per-step causality). Neither answers the question a fleet controller
has to ask: "what has tenant 3's p99 TTFT been doing over the last 60
seconds, and how fast is its error budget burning?" — that needs the
metrics *over time*. This module is that layer: a fixed-size ring
time-series store the serve loop feeds every existing gauge value and
counter into, with windowed ``rate()``/``mean()``/``max()``/
``quantile()`` queries, a structured :class:`Alert` log (SLO burns and
live pathology detections land here), and a JSON export.

Design points (same discipline as the flight recorder):

* **O(1) append** — each series is a pre-allocated ring of
  ``(monotonic_t, value)`` pairs; recording a sample is two list
  assignments under one lock.
* **zero cost when not attached** — the server's off-path is a single
  detached-attribute check (``if self.metrics_store is not None``);
  nothing in the engine or the serve loop touches this module unless a
  store is attached.
* **monotonic stamps** — samples are stamped with ``time.monotonic()``
  (the serving stack's deadline clock), so windows survive wall-clock
  adjustments and compare directly against request deadlines.
* **labels are data, not schema** — a series is keyed by
  ``(name, sorted(labels))``; the per-tenant latency series
  (``ttft_s{tenant="3"}``) and per-replica fleet merges ride the same
  mechanism the telemetry's ``tenant_tokens`` uses.

Alert *kinds* ARE schema: every ``Alert.kind`` raised anywhere in the
tree must appear in :data:`ALERT_KINDS`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

__all__ = ["Alert", "ALERT_KINDS", "MetricsStore", "Series",
           "nearest_rank_quantile"]


def nearest_rank_quantile(values, q):
    """Nearest-rank q-quantile of a value list (0.0 when empty) — THE
    one copy of the rank rule (``ceil(q*n)``-th smallest), shared by
    :meth:`Series.quantile` and the SLO engine's ``evaluate_slo`` so
    the two can never disagree on the same data. The ceil form matters
    at integral ranks: the p99 of 100 samples is the 99th smallest —
    traffic with EXACTLY the 1% bad events a p99 budget allows must
    measure at the good value, not the one outlier. ``values`` may be
    unsorted."""
    if not values:
        return 0.0
    vals = sorted(values)
    rank = -(-q * len(vals) // 1)           # ceil without an import
    return vals[min(max(int(rank) - 1, 0), len(vals) - 1)]

#: every Alert.kind the tree may raise — the strict-name registry.
#: "slo_burn" is the SLO engine's multi-window burn-rate alert; the rest
#: are the live pathology detectors' kinds (the reference's
#: ``profiler/slo.py``, not ported yet: ROADMAP A11), one per
#: explain_tail cause family promoted from post-hoc to streaming.
ALERT_KINDS = (
    "slo_burn",
    "ramp_thrash",
    "host_sync_regression",
    "spec_acceptance_collapse",
    "adapter_swap_storm",
    "swap_stall",
)


@dataclasses.dataclass
class Alert:
    """One structured alert: raised by the SLO engine or a pathology
    detector, cleared when the condition recovers. ``labels``
    distinguishes instances of one kind (``{"slo": "victim_ttft"}``);
    an alert stays in the store's bounded log after clearing so a
    report can answer "did it fire during the run" post-hoc."""
    kind: str                       # one of ALERT_KINDS
    message: str
    raised_t: float                 # time.monotonic() at raise
    severity: str = "warning"
    labels: dict = dataclasses.field(default_factory=dict)
    data: dict = dataclasses.field(default_factory=dict)
    cleared_t: float | None = None

    @property
    def active(self):
        return self.cleared_t is None

    def to_dict(self):
        return {"kind": self.kind, "message": self.message,
                "severity": self.severity,
                "labels": dict(self.labels), "data": dict(self.data),
                "raised_t": round(self.raised_t, 6),
                "cleared_t": (round(self.cleared_t, 6)
                              if self.cleared_t is not None else None),
                "active": self.active}


class Series:
    """One metric's fixed-size sample ring: ``(t, value)`` pairs, oldest
    evicted on wrap. Appends are O(1); windowed reads walk at most
    ``capacity`` samples (bounded, lock-held by the owning store)."""

    __slots__ = ("name", "labels", "capacity", "_t", "_v", "_n")

    def __init__(self, name, labels=(), capacity=1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.labels = tuple(labels)      # sorted (key, value) pairs
        self.capacity = int(capacity)
        self._t = [0.0] * self.capacity
        self._v = [0.0] * self.capacity
        self._n = 0                      # total samples ever appended

    def append(self, t, v):
        i = self._n % self.capacity
        self._t[i] = t
        self._v[i] = v
        self._n += 1

    def __len__(self):
        return min(self._n, self.capacity)

    @property
    def total_samples(self):
        return self._n

    def samples(self, since=None):
        """Retained ``(t, value)`` pairs, oldest first, optionally only
        those with ``t >= since``."""
        lo = max(0, self._n - self.capacity)
        out = []
        for i in range(lo, self._n):
            t = self._t[i % self.capacity]
            if since is None or t >= since:
                out.append((t, self._v[i % self.capacity]))
        return out

    def last(self):
        """The newest ``(t, value)``, or None on an empty series."""
        if not self._n:
            return None
        i = (self._n - 1) % self.capacity
        return (self._t[i], self._v[i])

    # -- windowed queries ----------------------------------------------
    def values(self, window_s=None, now=None):
        since = None
        if window_s is not None:
            if now is None:
                now = time.monotonic()
            since = now - window_s
        return [v for _, v in self.samples(since)]

    def mean(self, window_s=None, now=None):
        vals = self.values(window_s, now)
        return sum(vals) / len(vals) if vals else 0.0

    def max(self, window_s=None, now=None):
        vals = self.values(window_s, now)
        return max(vals) if vals else 0.0

    def rate(self, window_s=None, now=None):
        """Per-second delta of a CUMULATIVE series over the window:
        ``(v_last - v_first) / (t_last - t_first)`` for the retained
        samples inside it. 0.0 with <2 samples or a non-increasing
        clock; negative deltas (a counter reset) clamp to 0.0."""
        pts = self.samples(None if window_s is None else
                           (now if now is not None else time.monotonic())
                           - window_s)
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return max(v1 - v0, 0.0) / (t1 - t0)

    def quantile(self, q, window_s=None, now=None):
        """Nearest-rank q-quantile of the retained samples in the
        window (sorts up to ``capacity`` values — bounded)."""
        return nearest_rank_quantile(self.values(window_s, now), q)

    def truncated_for(self, window_s, now=None):
        """True when the ring has WRAPPED and its oldest retained
        sample is newer than the window start — a windowed read over
        ``window_s`` silently sees less history than asked for (grow
        ``capacity`` or the feed interval)."""
        if self._n <= self.capacity:
            return False
        if now is None:
            now = time.monotonic()
        oldest = self._t[self._n % self.capacity]
        return oldest > now - window_s

    def snapshot(self, max_samples=64):
        """JSON-ready summary + newest ``max_samples`` raw samples."""
        pts = self.samples()
        tail = pts[-max_samples:] if max_samples else []
        vals = [v for _, v in pts]
        return {"name": self.name,
                "labels": {k: v for k, v in self.labels},
                "samples_retained": len(pts),
                "samples_total": self._n,
                "last": (round(pts[-1][1], 6) if pts else None),
                "mean": (round(sum(vals) / len(vals), 6) if vals else None),
                "max": (round(max(vals), 6) if vals else None),
                "tail": [[round(t, 6), round(v, 6)] for t, v in tail]}


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _merge_labels(labels, kw):
    """Compose the ``labels=``-dict and ``**kwargs`` spellings into one
    label dict — both are accepted everywhere so neither style can
    silently query a phantom series."""
    if not labels:
        return kw
    merged = dict(labels)
    merged.update(kw)
    return merged


class MetricsStore:
    """Thread-safe collection of :class:`Series` + the bounded alert
    log. Writers: the serve loop (gauge/counter feed, one throttled
    pass per loop iteration), the token hot path (latency samples), the
    SLO engine and the pathology detectors (alerts). Readers: any
    thread (``slo_report``, the router's fleet merge, tests)."""

    def __init__(self, capacity=4096, max_alerts=256):
        self.capacity = int(capacity)
        self.max_alerts = int(max_alerts)
        self._lock = threading.Lock()
        self._series: dict[tuple, Series] = {}
        self._alerts: list[Alert] = []

    # -- write side ----------------------------------------------------
    def observe(self, name, value, t=None, labels=None, **kw):
        """Append one sample to series ``name{labels}`` (created on
        first sighting). ``t`` defaults to ``time.monotonic()``.
        Labels compose from the ``labels`` dict AND keyword arguments
        (every query method accepts both spellings too, so a caller
        mirroring either style hits the same series)."""
        if t is None:
            t = time.monotonic()
        key = (name, _label_key(_merge_labels(labels, kw)))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = Series(name, key[1], self.capacity)
            s.append(t, float(value))

    def raise_alert(self, kind, message, severity="warning", labels=None,
                    data=None):
        """Raise (or refresh) an alert. Deduped on ``(kind, labels)``:
        an already-ACTIVE instance is returned with its ``data``
        refreshed rather than duplicated, so a condition that holds for
        a thousand evaluations is one log entry."""
        labels = dict(labels or {})
        with self._lock:
            for a in reversed(self._alerts):
                if a.kind == kind and a.labels == labels and a.active:
                    if data:
                        a.data.update(data)
                    a.message = message
                    return a
            alert = Alert(kind, message, time.monotonic(),
                          severity=severity, labels=labels,
                          data=dict(data or {}))
            self._alerts.append(alert)
            if len(self._alerts) > self.max_alerts:
                # evict oldest CLEARED first; never silently drop an
                # active alert while an inactive one survives
                for i, old in enumerate(self._alerts):
                    if not old.active:
                        del self._alerts[i]
                        break
                else:
                    del self._alerts[0]
            return alert

    def clear_alert(self, kind, labels=None):
        """Clear the active alert matching ``(kind, labels)``. Returns
        the cleared alert, or None when nothing was active."""
        labels = dict(labels or {})
        with self._lock:
            for a in reversed(self._alerts):
                if a.kind == kind and a.labels == labels and a.active:
                    a.cleared_t = time.monotonic()
                    return a
        return None

    # -- read side -----------------------------------------------------
    def series(self, name, labels=None, **kw):
        """The exact series ``name{labels}``, or None."""
        with self._lock:
            return self._series.get(
                (name, _label_key(_merge_labels(labels, kw))))

    def matching(self, name, labels=None):
        """Every series named ``name``; with ``labels``, only those
        carrying ALL the given label pairs (a subset match, so
        ``matching("ttft_s")`` aggregates across tenants)."""
        want = _label_key(labels or {})
        with self._lock:
            return [s for (n, _), s in self._series.items()
                    if n == name and set(want) <= set(s.labels)]

    def values(self, name, window_s=None, now=None, labels=None):
        """Windowed sample VALUES concatenated across every matching
        series — the SLO engine's read (and, fed multiple stores'
        results, the fleet-level evaluation)."""
        out = []
        for s in self.matching(name, labels):
            with self._lock:
                out.extend(s.values(window_s, now))
        return out

    def window_truncated(self, name, window_s, now=None, labels=None):
        """True when ANY matching series' ring wrapped inside the
        window — the windowed read saw less history than ``window_s``
        asked for. The SLO engine surfaces this per evaluation so a
        high-rate series cannot silently collapse the slow window into
        the fast one."""
        if now is None:
            now = time.monotonic()
        for s in self.matching(name, labels):
            with self._lock:
                if s.truncated_for(window_s, now):
                    return True
        return False

    def rate(self, name, window_s=None, now=None, labels=None, **kw):
        # Series reads hold the store lock (the ring is mutated by
        # concurrent observe() appends — an unlocked samples() walk can
        # see a torn oldest slot and silently return 0/garbage)
        key = (name, _label_key(_merge_labels(labels, kw)))
        with self._lock:
            s = self._series.get(key)
            return s.rate(window_s, now) if s is not None else 0.0

    def mean(self, name, window_s=None, now=None, labels=None, **kw):
        key = (name, _label_key(_merge_labels(labels, kw)))
        with self._lock:
            s = self._series.get(key)
            return s.mean(window_s, now) if s is not None else 0.0

    def max(self, name, window_s=None, now=None, labels=None, **kw):
        key = (name, _label_key(_merge_labels(labels, kw)))
        with self._lock:
            s = self._series.get(key)
            return s.max(window_s, now) if s is not None else 0.0

    def last(self, name, labels=None, **kw):
        key = (name, _label_key(_merge_labels(labels, kw)))
        with self._lock:
            s = self._series.get(key)
            pt = s.last() if s is not None else None
        return pt[1] if pt is not None else None

    def windowed_values(self, name, window_s, fast_window_s=None,
                        now=None, labels=None):
        """ONE locked walk per matching series serving the SLO
        engine's whole read: ``(slow_values, fast_values, truncated)``
        — the fast-window values are the tail of the slow window's
        samples and ring truncation falls out of the same pass, so an
        evaluation costs one ring walk instead of three (these walks
        hold the store lock the token hot path's appends contend on)."""
        if now is None:
            now = time.monotonic()
        slow, fast = [], []
        truncated = False
        fast_since = now - fast_window_s if fast_window_s is not None \
            else None
        want = set(_label_key(labels or {}))
        with self._lock:
            for (n, _), s in self._series.items():
                if n != name or not want <= set(s.labels):
                    continue
                for t, v in s.samples(now - window_s):
                    slow.append(v)
                    if fast_since is not None and t >= fast_since:
                        fast.append(v)
                truncated = truncated or s.truncated_for(window_s, now)
        return slow, fast, truncated

    def alerts(self, active_only=False, kind=None):
        with self._lock:
            return [a for a in self._alerts
                    if (not active_only or a.active)
                    and (kind is None or a.kind == kind)]

    def snapshot(self, max_samples=64):
        """JSON-ready dump: every series' summary + the alert log."""
        with self._lock:
            series = [s.snapshot(max_samples)
                      for _, s in sorted(self._series.items())]
            alerts = [a.to_dict() for a in self._alerts]
        return {"series": series, "alerts": alerts,
                "capacity": self.capacity}

    def export_json(self, path, max_samples=256):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(max_samples), f, indent=1)
        return path
