"""paddle_tpu_torch.profiler.metrics_store (A11): ring semantics,
windowed queries, labels, alerts and the JSON export, the cases of
tests/test_metrics_store.py run against the port's module, and one
seeded random sequence of observations and alerts through both packages'
stores with equal answers. Pure host, well under a second.
"""
import json
import time

import numpy as np
import pytest

from paddle_tpu.profiler import metrics_store as jms

from paddle_tpu_torch.profiler import metrics_store as tms
from paddle_tpu_torch.profiler.metrics_store import (Alert, ALERT_KINDS,
                                                     MetricsStore, Series)


# ---------------------------------------------------------------------------
# Series — the ring
# ---------------------------------------------------------------------------

def test_series_append_and_wrap():
    s = Series("x", capacity=4)
    for i in range(10):
        s.append(float(i), float(i * 10))
    assert len(s) == 4
    assert s.total_samples == 10
    # oldest evicted: retained samples are the newest 4, oldest first
    assert s.samples() == [(6.0, 60.0), (7.0, 70.0), (8.0, 80.0),
                           (9.0, 90.0)]
    assert s.last() == (9.0, 90.0)


def test_series_windowed_queries():
    s = Series("x", capacity=64)
    for i in range(10):
        s.append(float(i), float(i))
    # window [6, 9]: values 7, 8, 9 (since = now - window)
    assert s.values(window_s=2.0, now=9.0) == [7.0, 8.0, 9.0]
    assert s.mean(window_s=2.0, now=9.0) == pytest.approx(8.0)
    assert s.max(window_s=2.0, now=9.0) == 9.0
    # whole-series fallbacks
    assert s.mean() == pytest.approx(4.5)
    assert s.max() == 9.0
    # empty window
    assert s.values(window_s=1.0, now=100.0) == []
    assert s.mean(window_s=1.0, now=100.0) == 0.0


def test_series_rate_is_cumulative_delta():
    s = Series("tokens_total", capacity=64)
    for i in range(5):
        s.append(float(i), float(i * 100))    # +100/s
    assert s.rate() == pytest.approx(100.0)
    assert s.rate(window_s=2.0, now=4.0) == pytest.approx(100.0)
    # <2 samples or a counter reset: 0, never negative
    assert Series("y").rate() == 0.0
    s.append(5.0, 0.0)                        # reset
    assert s.rate(window_s=1.5, now=5.0) == 0.0


def test_series_window_truncation_detection():
    s = Series("hot", capacity=4)
    for i in range(3):
        s.append(float(i), 1.0)
    # not wrapped yet: whatever the window, nothing was evicted
    assert not s.truncated_for(10.0, now=2.0)
    for i in range(3, 10):
        s.append(float(i), 1.0)
    # wrapped: oldest retained is t=6 — a 10s window at now=9 asked
    # for history back to t=-1 that the ring no longer holds
    assert s.truncated_for(10.0, now=9.0)
    # a window fully inside the retained span is fine
    assert not s.truncated_for(2.0, now=9.0)
    st = MetricsStore(capacity=4)
    for i in range(10):
        st.observe("ttft_s", 1.0, t=float(i), tenant=0)
    assert st.window_truncated("ttft_s", 10.0, now=9.0)
    assert not st.window_truncated("ttft_s", 2.0, now=9.0)
    assert not st.window_truncated("absent", 10.0, now=9.0)


def test_series_quantile_nearest_rank():
    from paddle_tpu_torch.profiler.metrics_store import nearest_rank_quantile

    s = Series("lat", capacity=128)
    for i in range(100):
        s.append(float(i), float(i))          # values 0..99
    # nearest-rank = ceil(q*n)-th smallest: p50 of 100 is the 50th
    # (value 49), p99 the 99th (value 98) — at an integral rank the
    # quantile must NOT jump to the next value: traffic with exactly
    # the 1% bad events a p99 budget allows measures at the good value
    assert s.quantile(0.5) == 49.0
    assert s.quantile(0.99) == 98.0
    assert s.quantile(1.0) == 99.0
    # windowed: [89..99] = 11 samples, ceil(0.99*11) = 11th -> 99
    assert s.quantile(0.99, window_s=10.0, now=99.0) == 99.0
    assert Series("z").quantile(0.5) == 0.0
    assert nearest_rank_quantile([10.0] * 99 + [5000.0], 0.99) == 10.0
    assert nearest_rank_quantile([1.0, 100.0], 0.5) == 1.0
    assert nearest_rank_quantile([7.0], 0.99) == 7.0


# ---------------------------------------------------------------------------
# MetricsStore — labels, queries, snapshot
# ---------------------------------------------------------------------------

def test_store_labels_fork_series():
    st = MetricsStore()
    st.observe("ttft_s", 0.1, t=1.0, tenant=0)
    st.observe("ttft_s", 0.9, t=1.0, tenant=1)
    st.observe("ttft_s", 0.2, t=2.0, tenant=0)
    assert st.series("ttft_s", tenant=0).values() == [0.1, 0.2]
    assert st.series("ttft_s", tenant=1).values() == [0.9]
    assert st.series("ttft_s") is None        # unlabeled never written
    # subset match aggregates across tenants
    assert sorted(st.values("ttft_s")) == [0.1, 0.2, 0.9]
    assert st.values("ttft_s", labels={"tenant": "1"}) == [0.9]
    assert st.last("ttft_s", tenant=0) == 0.2
    assert st.mean("ttft_s", tenant=0) == pytest.approx(0.15)
    # both label spellings hit the SAME series everywhere — a labels=
    # dict on the kwargs-style methods must not query a phantom series
    assert st.last("ttft_s", labels={"tenant": 0}) == 0.2
    assert st.mean("ttft_s", labels={"tenant": "0"}) == pytest.approx(0.15)
    assert st.series("ttft_s", labels={"tenant": 1}).values() == [0.9]
    st.observe("ttft_s", 0.3, t=3.0, labels={"tenant": 0})
    assert st.last("ttft_s", tenant=0) == 0.3
    # one-walk SLO read: (slow, fast, truncated) over the same series
    slow, fast, trunc = st.windowed_values(
        "ttft_s", 10.0, fast_window_s=1.5, now=3.0,
        labels={"tenant": "0"})
    assert slow == [0.1, 0.2, 0.3] and fast == [0.2, 0.3]
    assert trunc is False


def test_store_snapshot_json_round_trip(tmp_path):
    st = MetricsStore(capacity=8)
    for i in range(20):
        st.observe("queue_depth", i, t=float(i))
    st.observe("ttft_s", 0.5, t=1.0, tenant=3)
    st.raise_alert("slo_burn", "burning", labels={"slo": "a"})
    snap = st.snapshot()
    json.dumps(snap)                          # JSON-ready end to end
    names = {s["name"] for s in snap["series"]}
    assert names == {"queue_depth", "ttft_s"}
    (qd,) = [s for s in snap["series"] if s["name"] == "queue_depth"]
    assert qd["samples_retained"] == 8 and qd["samples_total"] == 20
    assert qd["last"] == 19
    (tt,) = [s for s in snap["series"] if s["name"] == "ttft_s"]
    assert tt["labels"] == {"tenant": "3"}
    assert len(snap["alerts"]) == 1
    path = st.export_json(str(tmp_path / "store.json"))
    assert json.load(open(path))["series"]


# ---------------------------------------------------------------------------
# alerts — raise / dedupe / clear / bound
# ---------------------------------------------------------------------------

def test_alert_raise_dedupe_clear():
    st = MetricsStore()
    a1 = st.raise_alert("ramp_thrash", "churn", data={"preemptions": 3})
    assert a1.active and a1.kind in ALERT_KINDS
    # duplicate raise of an ACTIVE (kind, labels): refreshed, not forked
    a2 = st.raise_alert("ramp_thrash", "still churning",
                        data={"preemptions": 5})
    assert a2 is a1
    assert a1.message == "still churning" and a1.data["preemptions"] == 5
    assert len(st.alerts()) == 1
    # distinct labels are a distinct instance
    st.raise_alert("slo_burn", "x", labels={"slo": "a"})
    st.raise_alert("slo_burn", "y", labels={"slo": "b"})
    assert len(st.alerts(kind="slo_burn")) == 2
    cleared = st.clear_alert("slo_burn", labels={"slo": "a"})
    assert cleared is not None and not cleared.active
    assert st.clear_alert("slo_burn", labels={"slo": "a"}) is None
    assert len(st.alerts(active_only=True)) == 2
    # a cleared alert REMAINS in the log — "did it fire" is answerable
    assert len(st.alerts()) == 3
    # re-raise after clear: a NEW instance (new raised_t)
    st.raise_alert("slo_burn", "again", labels={"slo": "a"})
    assert len(st.alerts(kind="slo_burn")) == 3


def test_alert_log_bounded_evicts_cleared_first():
    st = MetricsStore(max_alerts=4)
    keep = st.raise_alert("slo_burn", "active one", labels={"slo": "keep"})
    for i in range(10):
        st.raise_alert("ramp_thrash", f"m{i}", labels={"i": i})
        st.clear_alert("ramp_thrash", labels={"i": i})
    assert len(st.alerts()) <= 4
    assert keep in st.alerts(active_only=True)


def test_alert_to_dict_schema():
    a = Alert("swap_stall", "msg", 1.0, labels={"x": "y"},
              data={"n": 1})
    d = a.to_dict()
    for key in ("kind", "message", "severity", "labels", "data",
                "raised_t", "cleared_t", "active"):
        assert key in d
    assert d["active"] is True
    json.dumps(d)


# ---------------------------------------------------------------------------
# parity with the reference's store
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _feed(mod, seed):
    """One seeded sequence: gauges, counters and per-tenant latencies at
    explicit and clock stamps, alerts raised, refreshed and cleared past
    the log's bound."""
    rng = np.random.default_rng(seed)
    st = mod.MetricsStore(capacity=32, max_alerts=6)
    t, total = 0.0, 0
    for _ in range(300):
        t += float(rng.uniform(0.0, 0.2))
        what = int(rng.integers(0, 6))
        if what == 0:
            total += int(rng.integers(0, 9))
            st.observe("tokens_emitted", total, t=t)
        elif what == 1:
            st.observe("queue_depth", int(rng.integers(0, 5)), t=t)
        elif what == 2:
            st.observe("ttft_s", float(rng.exponential(0.2)), t=t,
                       tenant=int(rng.integers(0, 3)))
        elif what == 3:
            st.observe("inter_token_s", float(rng.exponential(0.01)),
                       labels={"tenant": int(rng.integers(0, 3))})
        elif what == 4:
            kind = ALERT_KINDS[int(rng.integers(0, len(ALERT_KINDS)))]
            st.raise_alert(kind, f"m{int(rng.integers(0, 99))}",
                           labels={"i": int(rng.integers(0, 4))},
                           data={"n": int(rng.integers(0, 9))})
        else:
            kind = ALERT_KINDS[int(rng.integers(0, len(ALERT_KINDS)))]
            st.clear_alert(kind, labels={"i": int(rng.integers(0, 4))})
    now = t
    out = {"snapshot": st.snapshot(), "snapshot_8": st.snapshot(8),
           "alerts": [a.to_dict() for a in st.alerts()],
           "active": [a.to_dict() for a in st.alerts(active_only=True)]}
    for w in (None, 1.0, 5.0, 100.0):
        out[f"rate_{w}"] = st.rate("tokens_emitted", window_s=w, now=now)
        out[f"mean_{w}"] = st.mean("queue_depth", window_s=w, now=now)
        out[f"max_{w}"] = st.max("queue_depth", window_s=w, now=now)
        for tenant in (0, 1, 2):
            out[f"q_{w}_{tenant}"] = mod.nearest_rank_quantile(
                st.values("ttft_s", window_s=w, now=now,
                          labels={"tenant": tenant}), 0.9)
        if w is not None:
            out[f"windowed_{w}"] = st.windowed_values(
                "ttft_s", w, fast_window_s=w / 4, now=now)
            out[f"trunc_{w}"] = st.window_truncated("ttft_s", w, now=now)
    s = st.series("ttft_s", tenant=1)
    out["series"] = (s.samples(), s.quantile(0.5), s.quantile(0.99),
                     s.total_samples, s.last())
    out["last"] = st.last("inter_token_s", tenant=2)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_store_matches_reference(monkeypatch, seed):
    results = []
    for mod in (jms, tms):
        monkeypatch.setattr(time, "monotonic", _Clock())
        results.append(_feed(mod, seed))
    ref, got = results
    assert got == ref
    assert got["alerts"] and got["snapshot"]["series"]
    assert tms.ALERT_KINDS == jms.ALERT_KINDS
