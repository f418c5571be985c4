"""Per-stage serving telemetry — the observability layer of
``paddle_tpu_torch.serving`` (counterpart:
``paddle_tpu/profiler/serving_telemetry.py``, ported verbatim; reference analog: the serving-side statistics the
reference's AnalysisPredictor/PaddleNLP stack exposes through
paddle.profiler summaries; here the consumer is a SERVER loop, so the
shapes are production-serving shapes: stage wall clocks, counters, and
latency histograms with a Prometheus-style text export).

Three pieces, all thread-safe (the engine thread writes, any thread
snapshots):

* **stage clocks** — monotonic wall-time accumulators for the named
  phases of the serve loop (``queue_admit``, ``prefill_dispatch``,
  ``schedule``, ``decode_dispatch``, ``host_sync``, ``emit``, ``idle``).
  ``attribution(wall_s)`` reports each stage's share of a wall-clock
  window and the total attributed fraction — the number the round-5
  verdict found missing (only 24% of serve wall was explained; the
  acceptance bar here is ≥90%).
* **counters** — requests submitted/admitted/finished/cancelled/expired/
  rejected, tokens emitted, engine steps.
* **gauges** — point-in-time engine state the server samples every loop
  pass: queue depth, running/waiting slots, KV-pool occupancy, token
  budget utilization, pipeline dispatches in flight.
* **latency histograms** — TTFT, inter-token gap, end-to-end, and queue
  wait, on log-spaced buckets with quantile estimates.

Names are STRICT: ``add_stage``/``inc``/``set_gauge`` raise ``KeyError``
for a name that was never declared — a typo'd stage or counter name must
fail loudly instead of silently forking the attribution into a phantom
key. Extensions declare their names first via :meth:`ServingTelemetry
.register` (they survive :meth:`reset`).

Export: :meth:`ServingTelemetry.snapshot` (JSON-ready dict) and
:meth:`ServingTelemetry.prometheus_text` (text exposition format).
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time

__all__ = ["LatencyHistogram", "ServingTelemetry", "STAGES", "GAUGES",
           "LABELED_GAUGE_FAMILIES"]

#: the named stages of the serve loop, in pipeline order. Every second of
#: busy engine-thread wall time lands in exactly one of these (or in
#: "other", the loop's own bookkeeping remainder).
STAGES = ("queue_admit", "prefill_dispatch", "schedule", "decode_dispatch",
          "host_sync", "emit", "idle", "other")

#: point-in-time gauges the serve loop samples each pass (pool gauges
#: stay 0 on the dense engine; budget utilization needs the flight
#: recorder's last StepRecord and stays 0 without one; prefix gauges
#: stay 0 unless the engine runs enable_prefix_cache). server_healthy
#: is the health-protocol gauge: 1 while the serve loop heartbeats, 0
#: when the watchdog declares it hung or a crash lands — the replica
#: router's failover signal, and 0 on a never-started server.
GAUGES = ("queue_depth", "engine_waiting", "running_slots",
          "pipeline_inflight", "kv_pool_free_blocks", "kv_pool_occupancy",
          "token_budget_utilization", "prefix_cached_blocks",
          "prefix_cache_hit_rate", "server_healthy",
          "adapter_cache_occupancy",
          # speculative serving: cumulative accepted/proposed draft
          # ratio (stays 0 on non-speculative engines)
          "spec_acceptance_rate",
          # quantized KV serving: pool capacity in BF16-EQUIVALENT block
          # counts (n_blocks unquantized, ~2x/~4x under int8/int4) —
          # one capacity number comparable across kv_cache_dtype arms
          "kv_pool_effective_blocks",
          # host KV tier: cumulative bytes moved each way by the
          # PREEMPTION-SWAP half (spill/promote traffic counts blocks on
          # kv_spill_blocks/kv_promote_blocks instead — the swap bytes
          # double as the preempt_swap classifier signal), and the host
          # spill store's current block count (all 0 with the tier off)
          "kv_swap_in_bytes", "kv_swap_out_bytes", "kv_host_spill_blocks",
          # the spill store's byte occupancy — same store as
          # kv_host_spill_blocks, in the unit its bound is set in
          "kv_host_spill_bytes",
          # gauge STALENESS: seconds since the serve loop last sampled
          # the point-in-time gauges (mark_gauge_sample). Computed at
          # READ time from the sampling stamp — a hung/idle loop's
          # stale gauges are visible as a GROWING age instead of
          # silently frozen values (the watchdog's hung flip does not
          # refresh it: only a real loop pass does)
          "gauge_last_sample_age_s")

#: labeled gauge FAMILIES — dynamic-label metric families (like
#: tenant_tokens): the SLO engine's per-objective burn gauges and the
#: live pathology detectors' active flags. Family -> its label key.
#: Families are schema (strict: set_labeled_gauge raises KeyError on an
#: unknown one, and the PTL007 analysis pass checks call sites); the
#: label VALUES (slo names, detector kinds) are data.
LABELED_GAUGE_FAMILIES = {"slo_burn_rate": "slo",
                          "slo_breached": "slo",
                          "pathology_active": "kind"}

#: latency families that keep PER-TENANT histograms alongside the
#: global ones (observe(..., tenant=i)); admission_stall stays global
#: (admission is a shared-queue property, not a tenant one).
_TENANT_HISTS = ("ttft_s", "inter_token_s", "e2e_s", "queue_wait_s")

_COUNTERS = ("requests_submitted", "requests_admitted", "requests_finished",
             "requests_cancelled", "requests_expired",
             "requests_rejected_queue_full", "requests_rejected_validation",
             "requests_shed_deadline", "requests_resumed",
             "engine_restarts", "faults_injected", "tokens_emitted",
             "engine_steps", "multi_steps", "preemptions", "prefill_tokens",
             "prefix_hit_tokens", "prefix_cow_blocks",
             "prefix_evicted_blocks",
             "adapter_cache_hits", "adapter_cache_misses", "adapter_swaps",
             "embed_requests",
             "spec_proposed_tokens", "spec_accepted_tokens",
             # host KV tier: blocks swapped out at preemption / restored
             # at re-admission, re-prefill tokens the restores avoided,
             # and prefix blocks spilled to / promoted from the host
             # store
             "kv_swap_out_blocks", "kv_swap_in_blocks",
             "kv_swap_saved_tokens", "kv_spill_blocks",
             "kv_promote_blocks",
             # disaggregated serving: cross-replica KV shipped out of /
             # into this replica (staged-entry exports + pull-on-miss
             # prefix blocks) — booked apart from the swap counters so
             # the preemption classifier's signal stays exclusive
             "kv_ship_out_blocks", "kv_ship_in_blocks",
             "kv_ship_out_bytes", "kv_ship_in_bytes")


def _default_bounds():
    """Log-spaced bucket upper bounds: 0.1 ms .. ~105 s, x2 per bucket —
    21 buckets cover sub-ms token gaps and multi-second e2e latencies."""
    return tuple(1e-4 * (2.0 ** i) for i in range(21))


class LatencyHistogram:
    """Fixed-bucket latency histogram (seconds). Cheap enough for the
    per-token hot path: one bisect + three adds per observation."""

    __slots__ = ("bounds", "counts", "count", "total", "minimum", "maximum")

    def __init__(self, bounds=None):
        self.bounds = tuple(bounds) if bounds is not None \
            else _default_bounds()
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = overflow bucket
        self.count = 0
        self.total = 0.0
        self.minimum = float("inf")
        self.maximum = 0.0

    def observe(self, v):
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        self.minimum = min(self.minimum, v)
        self.maximum = max(self.maximum, v)

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    def quantile(self, q):
        """Upper-bound estimate of the q-quantile from bucket counts (the
        bucket's upper bound; overflow bucket reports the observed max)."""
        if not self.count:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return self.bounds[i] if i < len(self.bounds) \
                    else self.maximum
        return self.maximum

    def snapshot(self):
        return {"count": self.count,
                "mean_s": round(self.mean, 6),
                "min_s": round(self.minimum, 6) if self.count else 0.0,
                "max_s": round(self.maximum, 6),
                "p50_s": round(self.quantile(0.5), 6),
                "p90_s": round(self.quantile(0.9), 6),
                "p99_s": round(self.quantile(0.99), 6)}

    def copy(self):
        out = LatencyHistogram(self.bounds)
        out.counts = list(self.counts)
        out.count = self.count
        out.total = self.total
        out.minimum = self.minimum
        out.maximum = self.maximum
        return out

    def merge(self, other):
        """BUCKET-WISE merge of another histogram into this one — the
        fleet aggregation primitive (N replicas' per-tenant histograms
        sum into one whose quantile estimates are exact at bucket
        resolution, which per-replica quantiles can never recombine
        into). Requires identical bucket bounds."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        if other.count:
            self.minimum = min(self.minimum, other.minimum)
            self.maximum = max(self.maximum, other.maximum)
        return self

    def prometheus_lines(self, name, labels="", type_line=True):
        """Cumulative-bucket exposition lines (histogram type).
        ``labels``: extra label body WITHOUT braces or leading comma
        (e.g. ``replica="0"``) — composed correctly into both the
        ``le``-labeled bucket lines and the bare sum/count lines.
        ``type_line=False`` omits the ``# TYPE`` header — for extra
        labeled series (per-tenant) of a family whose header an earlier
        histogram already emitted (a repeated TYPE line within one
        exposition is invalid)."""
        sep = ("," + labels) if labels else ""
        bare = ("{" + labels + "}") if labels else ""
        lines = [f"# TYPE {name} histogram"] if type_line else []
        acc = 0
        for bound, c in zip(self.bounds, self.counts):
            acc += c
            lines.append(f'{name}_bucket{{le="{bound:g}"{sep}}} {acc}')
        lines.append(f'{name}_bucket{{le="+Inf"{sep}}} {self.count}')
        lines.append(f"{name}_sum{bare} {self.total:g}")
        lines.append(f"{name}_count{bare} {self.count}")
        return lines


class ServingTelemetry:
    """The serve loop's stage clocks + counters + latency histograms.

    ``replica``: this telemetry's replica/rank index in a multi-replica
    cluster — every Prometheus line gains a ``replica="i"`` label so N
    replicas' scrapes aggregate instead of colliding, and snapshots
    carry the index. None = unlabeled single-server output (unchanged
    schema)."""

    def __init__(self, replica=None):
        self._lock = threading.Lock()
        self.replica = replica
        #: extension names declared via register(); they survive reset()
        self._extra = {"stage": set(), "counter": set(), "gauge": set()}
        self.reset()

    def register(self, kind, name):
        """Declare an EXTENSION stage/counter/gauge name — the escape
        hatch from the strict-name contract (unknown names raise
        KeyError so a typo can't silently fork the attribution into a
        phantom key). Registered names survive :meth:`reset`."""
        if kind not in ("stage", "counter", "gauge"):
            raise ValueError(f"register kind must be 'stage', 'counter' or "
                             f"'gauge', got {kind!r}")
        with self._lock:
            self._extra[kind].add(name)
            target = {"stage": self.stage_s, "counter": self.counters,
                      "gauge": self.gauges}[kind]
            target.setdefault(name, 0.0 if kind != "counter" else 0)

    def reset(self):
        with self._lock:
            self.started_at = time.perf_counter()
            self.stage_s = {name: 0.0 for name in STAGES}
            self.stage_s.update({n: 0.0 for n in self._extra["stage"]})
            self.counters = {name: 0 for name in _COUNTERS}
            self.counters.update({n: 0 for n in self._extra["counter"]})
            self.gauges = {name: 0.0 for name in GAUGES}
            self.gauges.update({n: 0.0 for n in self._extra["gauge"]})
            #: gauge STALENESS stamps (time.monotonic): per-gauge write
            #: times plus the serve loop's whole-pass sampling mark —
            #: gauge_last_sample_age_s is computed from these at READ
            #: time, so a hung loop's frozen gauges age visibly
            self.gauge_stamps = {}
            self._started_mono = time.monotonic()
            self._gauge_sample_t = None
            #: labeled gauge families (slo_burn_rate{slo=...},
            #: pathology_active{kind=...}): family -> {label: value}.
            #: Families are schema (LABELED_GAUGE_FAMILIES), labels are
            #: data — same split as tenant_tokens.
            self.labeled_gauges = {n: {} for n in LABELED_GAUGE_FAMILIES}
            #: per-TENANT latency histograms (adapter_id -> {family:
            #: LatencyHistogram}), populated lazily by observe(...,
            #: tenant=i) ALONGSIDE the global families — the per-tenant
            #: p99s the SLO layer scopes objectives against
            self.tenant_latency = {}
            #: per-TENANT processed-token counters (adapter_id ->
            #: tokens): generated tokens per tenant, plus an embed
            #: request's pooled prompt tokens at its finish. Tenant ids
            #: are data, not schema — a dynamic label on one metric
            #: family, outside the strict-name counter contract.
            self.tenant_tokens = {}
            self.ttft_s = LatencyHistogram()
            self.inter_token_s = LatencyHistogram()
            self.e2e_s = LatencyHistogram()
            self.queue_wait_s = LatencyHistogram()
            #: time a waiting request spent queued AFTER a free slot
            #: existed — admission lag behind capacity. The legacy
            #: admit-then-decode path pays it whenever prefill trains
            #: block the loop; the fused scheduler drives it to ~0.
            self.admission_stall_s = LatencyHistogram()

    # -- write side (engine thread + submitters) ------------------------
    def add_stage(self, name, dt):
        if dt <= 0.0 and name in self.stage_s:
            return
        with self._lock:
            if name not in self.stage_s:
                raise KeyError(
                    f"unknown telemetry stage {name!r} (a typo here would "
                    f"silently fork the attribution) — declare it with "
                    f"register('stage', {name!r}) first")
            self.stage_s[name] += dt

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(name, time.perf_counter() - t0)

    def inc(self, name, n=1):
        with self._lock:
            if name not in self.counters:
                raise KeyError(
                    f"unknown telemetry counter {name!r} — declare it with "
                    f"register('counter', {name!r}) first")
            self.counters[name] += n

    def inc_tenant(self, tenant, n=1):
        """Count ``n`` processed tokens against ``tenant`` (an adapter
        id; 0 = base). Tenants are dynamic data, so this is the one
        write-side entry point that does NOT require registration."""
        with self._lock:
            key = int(tenant)
            self.tenant_tokens[key] = self.tenant_tokens.get(key, 0) + n

    def set_gauge(self, name, value):
        with self._lock:
            if name not in self.gauges:
                raise KeyError(
                    f"unknown telemetry gauge {name!r} — declare it with "
                    f"register('gauge', {name!r}) first")
            self.gauges[name] = float(value)
            self.gauge_stamps[name] = time.monotonic()

    def set_labeled_gauge(self, family, label, value):
        """Set one labeled gauge sample (``family{<key>="<label>"}``).
        The FAMILY must be declared in :data:`LABELED_GAUGE_FAMILIES`
        (strict, like set_gauge); the label value is dynamic data (an
        SLO name, a detector kind)."""
        with self._lock:
            if family not in self.labeled_gauges:
                raise KeyError(
                    f"unknown labeled gauge family {family!r} — declare "
                    f"it in LABELED_GAUGE_FAMILIES")
            self.labeled_gauges[family][str(label)] = float(value)

    def mark_gauge_sample(self):
        """Stamp 'the serve loop sampled the gauges NOW' — the write
        side of ``gauge_last_sample_age_s``. Called once per loop pass
        (after ``_update_gauges``); deliberately NOT called by the
        watchdog or any out-of-loop writer, so a hung loop's age keeps
        growing even while the watchdog flips ``server_healthy``."""
        with self._lock:
            self._gauge_sample_t = time.monotonic()

    def _gauge_age_locked(self, now=None):
        """Seconds since the last loop-pass gauge sample (uptime when
        none happened yet). Caller holds the lock."""
        if now is None:
            now = time.monotonic()
        base = self._gauge_sample_t if self._gauge_sample_t is not None \
            else self._started_mono
        return max(now - base, 0.0)

    def observe(self, hist_name, v, tenant=None):
        """Observe one latency sample. With ``tenant`` set, the sample
        ALSO lands in that tenant's histogram of the same family
        (created lazily) — ``hist_name`` must then be one of
        :data:`_TENANT_HISTS` (strict)."""
        with self._lock:
            getattr(self, hist_name).observe(v)
            if tenant is None:
                return
            if hist_name not in _TENANT_HISTS:
                raise KeyError(
                    f"telemetry histogram {hist_name!r} has no per-tenant "
                    f"variant (families: {_TENANT_HISTS})")
            fams = self.tenant_latency.get(int(tenant))
            if fams is None:
                fams = self.tenant_latency[int(tenant)] = {
                    n: LatencyHistogram() for n in _TENANT_HISTS}
            fams[hist_name].observe(v)

    # -- read side ------------------------------------------------------
    def get_gauges(self):
        """Point-in-time copy of every gauge — the replica router's
        load-scoring read (one lock, one dict copy).
        ``gauge_last_sample_age_s`` is computed here, at read time: the
        stored 0.0 would claim freshness a hung loop does not have."""
        with self._lock:
            out = dict(self.gauges)
            out["gauge_last_sample_age_s"] = self._gauge_age_locked()
            return out

    def get_counters(self):
        """Point-in-time copy of every counter — the metrics-store
        feed's read (counter deltas become windowed rate() series)."""
        with self._lock:
            return dict(self.counters)

    def tenant_latency_hists(self):
        """Deep-copied per-tenant histograms ``{tenant: {family:
        LatencyHistogram}}`` — the fleet merge's input (copies, so the
        router's bucket-wise merge never mutates live telemetry)."""
        with self._lock:
            return {t: {n: h.copy() for n, h in fams.items()}
                    for t, fams in self.tenant_latency.items()}

    @staticmethod
    def render_tenant_latency(hists):
        """JSON-ready rendering of a ``{tenant: {family_name:
        LatencyHistogram}}`` map (family names lose their ``_s``
        suffix, mirroring the global ``latency`` snapshot keys) — THE
        one copy, shared by snapshot(), the server's slo_report and
        the router's fleet merge."""
        return {str(t): {n[:-2]: h.snapshot() for n, h in fams.items()}
                for t, fams in sorted(hists.items())}

    def tenant_latency_snapshot(self):
        """The per-tenant latency block as snapshot()/slo_report()
        expose it."""
        return self.render_tenant_latency(self.tenant_latency_hists())

    def attribution(self, wall_s=None, include_idle=False):
        """Per-stage share of ``wall_s`` (default: telemetry uptime) and
        the summed ``attributed_share`` — how much of the serve wall the
        named stages explain. ``idle`` is excluded by default so a mostly
        idle server doesn't trivially 'attribute' its wall."""
        with self._lock:
            stages = dict(self.stage_s)
            uptime = time.perf_counter() - self.started_at
        wall = wall_s if wall_s and wall_s > 0 else uptime
        named = {k: v for k, v in stages.items()
                 if include_idle or k != "idle"}
        shares = {k: round(v / wall, 4) for k, v in named.items()}
        return {"wall_s": round(wall, 4),
                "stage_share": shares,
                "attributed_share": round(
                    min(sum(named.values()) / wall, 1.0), 4)}

    def snapshot(self, wall_s=None):
        """JSON-ready snapshot: uptime, counters, per-stage seconds and
        shares, latency histograms."""
        with self._lock:
            out = {
                "replica": self.replica,
                "uptime_s": round(time.perf_counter() - self.started_at, 4),
                "counters": dict(self.counters),
                "tenant_tokens": {str(k): v for k, v
                                  in sorted(self.tenant_tokens.items())},
                "gauges": {k: round(v, 6) for k, v in self.gauges.items()},
                "labeled_gauges": {fam: dict(vals) for fam, vals
                                   in self.labeled_gauges.items()},
                "stages_s": {k: round(v, 6)
                             for k, v in self.stage_s.items()},
                "latency": {
                    "ttft": self.ttft_s.snapshot(),
                    "inter_token": self.inter_token_s.snapshot(),
                    "e2e": self.e2e_s.snapshot(),
                    "queue_wait": self.queue_wait_s.snapshot(),
                    "admission_stall": self.admission_stall_s.snapshot(),
                },
                "tenant_latency": self.render_tenant_latency(
                    self.tenant_latency),
            }
            out["gauges"]["gauge_last_sample_age_s"] = round(
                self._gauge_age_locked(), 6)
            now = time.monotonic()
            out["gauge_ages"] = {k: round(now - t, 6) for k, t
                                 in sorted(self.gauge_stamps.items())}
            prefill = self.counters["prefill_tokens"]
            decode = self.counters["tokens_emitted"]
            #: share of all processed tokens that were PREFILL — how much
            #: of the serve work is ramp-in (the fused scheduler's
            #: interference budget is about bounding this per step)
            out["prefill_token_share"] = round(
                prefill / (prefill + decode), 4) if prefill + decode else 0.0
        out["attribution"] = self.attribution(wall_s)
        return out

    def prometheus_text(self, prefix="paddle_tpu_serving"):
        """Prometheus text exposition: counters, gauges, stage-seconds
        counters, latency histograms. With ``replica`` set, every line
        carries ``replica="i"`` so a multi-replica scrape endpoint can
        concatenate N replicas' dumps without series collisions."""
        with self._lock:
            rep = self.replica
            lbl = f'replica="{rep}"' if rep is not None else ""
            brace = ("{" + lbl + "}") if lbl else ""
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            gauges["gauge_last_sample_age_s"] = self._gauge_age_locked()
            stages = dict(self.stage_s)
            hists = {"ttft_seconds": self.ttft_s,
                     "inter_token_seconds": self.inter_token_s,
                     "e2e_seconds": self.e2e_s,
                     "queue_wait_seconds": self.queue_wait_s,
                     "admission_stall_seconds": self.admission_stall_s}
            prefill = self.counters["prefill_tokens"]
            decode = self.counters["tokens_emitted"]
            share = prefill / (prefill + decode) if prefill + decode else 0.0
            lines = [f"# TYPE {prefix}_prefill_token_share gauge",
                     f"{prefix}_prefill_token_share{brace} {share:g}"]
            for name, val in sorted(counters.items()):
                full = f"{prefix}_{name}_total"
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full}{brace} {val}")
            if self.tenant_tokens:
                full = f"{prefix}_tenant_tokens_total"
                lines.append(f"# TYPE {full} counter")
                tenant_extra = ("," + lbl) if lbl else ""
                for tenant, val in sorted(self.tenant_tokens.items()):
                    lines.append(
                        f'{full}{{tenant="{tenant}"{tenant_extra}}} {val}')
            for name, val in sorted(gauges.items()):
                full = f"{prefix}_{name}"
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full}{brace} {val:g}")
            extra = ("," + lbl) if lbl else ""
            for fam, label_key in LABELED_GAUGE_FAMILIES.items():
                vals = self.labeled_gauges.get(fam)
                if not vals:
                    continue
                full = f"{prefix}_{fam}"
                lines.append(f"# TYPE {full} gauge")
                for label, v in sorted(vals.items()):
                    # exposition label-value escaping (SLO.name also
                    # validates, but detector kinds / future callers
                    # ride the same emitter): \ -> \\, " -> \", NL -> \n
                    esc = (str(label).replace("\\", "\\\\")
                           .replace('"', '\\"').replace("\n", "\\n"))
                    lines.append(
                        f'{full}{{{label_key}="{esc}"{extra}}} {v:g}')
            full = f"{prefix}_stage_seconds_total"
            lines.append(f"# TYPE {full} counter")
            stage_extra = ("," + lbl) if lbl else ""
            for name, val in sorted(stages.items()):
                lines.append(
                    f'{full}{{stage="{name}"{stage_extra}}} {val:g}')
            for name, h in hists.items():
                lines.extend(h.prometheus_lines(f"{prefix}_{name}",
                                                labels=lbl))
                # per-tenant series of the SAME family ride under the
                # global header (one # TYPE line per family — repeated
                # headers are invalid exposition), labeled tenant="i".
                # The histogram-attribute name derives from the
                # exposition name so promoting a family into
                # _TENANT_HISTS is one edit, not two.
                base = name.replace("_seconds", "_s")
                if base not in _TENANT_HISTS:
                    continue
                for tenant, fams in sorted(self.tenant_latency.items()):
                    th = fams.get(base)
                    if th is None or not th.count:
                        continue
                    tlbl = f'tenant="{tenant}"' + (("," + lbl) if lbl
                                                   else "")
                    lines.extend(th.prometheus_lines(
                        f"{prefix}_{name}", labels=tlbl, type_line=False))
        return "\n".join(lines) + "\n"
