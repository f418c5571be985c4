"""Engine flight recorder (counterpart:
``paddle_tpu/profiler/flight_recorder.py``, standard library only, ported
verbatim) — per-step ``StepRecord``s + per-request trace timelines,
joined by step id. The causal layer the aggregate serving
telemetry (``serving_telemetry.py``) cannot provide: a p99 inter-token
gap in a histogram looks identical whether it came from an interfering
prefill chunk, a pool-pressure preemption, a pipeline bubble, or a host
sync stall. The recorder answers "why was THIS token slow?".

Three pieces:

* **StepRecord ring** — a fixed-size ring buffer holding one record per
  engine step: scheduler kind, per-slot grants (prefill chunk vs decode
  token), token-budget utilization, queue depth, KV-pool free blocks,
  pipeline depth in flight, preemption events, and the
  admit/schedule/dispatch/sync/emit wall splits. The ring is
  pre-allocated; recording a step is one index assignment, so recorder
  overhead is bounded (and the whole recorder is disableable —
  ``enabled=False`` short-circuits every hook).
* **per-request span timelines** — queued → admitted → prefill chunks →
  first token → per-token gaps → finish reason, each span stamped with
  the step id that produced it, so request time joins back to engine
  state. Per-token cost is one append of a small tuple (the record
  itself) — no other allocation.
* **exports** — :meth:`FlightRecorder.export_chrome_trace` writes a
  chrome://tracing JSON with one lane per request plus an engine-step
  lane (chrome ``traceEvents`` in µs, so traces open in Perfetto and
  ``merge_profile`` merges them across ranks), and :meth:`FlightRecorder.explain_tail` joins the worst
  inter-token gaps to their causal StepRecord and names the dominant
  cause (interfering prefill / preemption / host sync / idle bubble).

Reference analog: the reference debugs its serving stack with
paddle.profiler timelines; vLLM/Sarathi-style continuous batching is
debugged in production with exactly this per-step/per-request trace
join (PAPERS.md: Sarathi-Serve's stall taxonomy is per-step).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time

__all__ = ["StepRecord", "FlightRecorder", "TAIL_CAUSES",
           "REQUEST_EVENT_KINDS", "COUNTER_TRACKS", "FLOW_EVENT_NAME"]

#: the cause labels explain_tail may assign, in priority order.
#: "restart_recovery" outranks everything: the gap spans a supervised
#: engine restart ("crashed" → "resumed" spans in the request timeline),
#: so the step facts explain the resumed side only, not the gap.
#: "batched_readout" refines host_sync for AMORTIZED readouts: the
#: gap's causal step drained a multi-row token burst in one sync
#: (multi-step readout_stride, a legacy horizon scan, or speculative
#: verify windows — StepRecord.readout_stride carries the row count
#: for all three), so a sync-dominated step is the amortization
#: boundary working as designed — tune the stride/horizon, not the
#: host — rather than a host-sync pathology.
#: The preemption cause is SPLIT by the host KV tier's involvement:
#: "preempt_swap" — the gap's causal step preempted slots whose KV
#: moved through the host tier (swap-out at the preemption, or a
#: swap-in restore at the re-admission): the stall is two overlapped
#: copies, already the cheap path — grow the pool or the spill budget
#: if it still hurts. "preempt_reprefill" — the step preempted with NO
#: tier traffic: the evicted KV was recomputed from scratch, the
#: expensive shape tiering exists to remove (kv_host_swap off, or the
#: entry was invalidated).
#: "adapter_swap" sits between preemption and interfering_prefill: the
#: gap's causal step swapped an adapter into the device cache (host
#: upload riding the admission path) — a multi-tenant working set
#: larger than the adapter cache, not a scheduling pathology.
#: "draft_rejected" names a speculative stall: the gap's causal step
#: carried verify grants whose drafts mostly ROLLED BACK (rejected >
#: accepted at readout), so the wall went to verifying tokens that
#: never committed — an acceptance problem (workload/draft mismatch;
#: the adaptive-k EWMA should be shrinking the window), not the
#: host-sync or batched-readout pathology it would otherwise file as.
#: "kv_ship" sits between adapter_swap and interfering_prefill: the
#: gap's causal step moved cross-replica ship traffic (a migrated
#: request's imported KV scattering in with its stitch grant, or a
#: finish-site export staging out) — disaggregation transfer cost, not
#: the prefill interference the mixed step would otherwise file as.
TAIL_CAUSES = ("restart_recovery", "preempt_swap", "preempt_reprefill",
               "adapter_swap", "kv_ship",
               "interfering_prefill", "draft_rejected", "batched_readout",
               "host_sync", "idle_bubble", "dispatch", "unrecorded")

#: every request-timeline event KIND the tree may record (the literal
#: second argument of :meth:`FlightRecorder.req_event`, plus the
#: "token" events :meth:`FlightRecorder.on_token` appends). STRICT
#: schema, like the telemetry names and alert kinds: every ``req_event``
#: call site's kind literal must be one of these, so a typo'd span name
#: cannot silently open a phantom lane in the chrome export.
REQUEST_EVENT_KINDS = (
    "queued",          # server admission-queue entry (restarts timeline)
    "routed",          # the ReplicaRouter's placement record
    "admitted",        # engine slot admission
    "prefill",         # one prefill chunk (value = token count)
    "cached_prefix",   # prompt tokens served from the prefix cache
    "token",           # one emitted token (value = inter-token gap)
    "kv_shipped_in",   # cross-replica shipped KV restored into a slot
    "kv_stitch",       # the shipped restore's stitch wall (value = s)
    "swapped_in",      # host-tier preemption swap restored into a slot
    "crashed",         # supervised serving loop crashed under this req
    "resumed",         # supervised restart re-admitted this request
    "finish",          # terminal (value = finish reason)
)

#: the Perfetto counter tracks ("ph":"C") the chrome export emits —
#: one line chart per name under the request lanes.
COUNTER_TRACKS = ("queue_depth", "token_budget_utilization",
                  "kv_pool_occupancy", "spec_acceptance_rate")

#: the name every cross-replica Perfetto flow event ("ph":"s"/"f")
#: carries — ``ReplicaRouter.export_merged_trace`` links a request's
#: per-hop lanes with s→f pairs under this one name (flow events match
#: on (name, cat, id), so the name IS schema).
FLOW_EVENT_NAME = "trace_flow"


@dataclasses.dataclass
class StepRecord:
    """One engine step's facts, captured at dispatch and completed at
    readout. ``grants`` is a tuple of ``(slot, request_id, kind,
    n_tokens)`` with kind ``"prefill"`` or ``"decode"`` — the per-slot
    work this step's single dispatch carried."""
    step_id: int
    t_begin: float                     # perf_counter at step_begin entry
    scheduler: str                     # "legacy" | "fused"
    kind: str                          # "decode" | "mixed" | "spec" | "drain"
    grants: tuple                      # ((slot, rid, kind, n_tokens), ...)
    tokens_scheduled: int              # sum of grant n_tokens
    token_budget: int                  # per-step token capacity
    queue_depth: int                   # engine.waiting after admission
    free_blocks: int | None            # paged pool free blocks (None: dense)
    total_blocks: int | None
    pipeline_inflight: int             # dispatches in flight incl. this one
    preemptions: tuple                 # request ids preempted/pool-retired
    admit_s: float                     # wall splits measured by the engine
    schedule_s: float
    dispatch_s: float
    t_finish: float = 0.0              # 0.0 until step_finish completes it
    sync_s: float = 0.0
    emit_s: float = 0.0
    finished: tuple = ()               # request ids retired at readout
    #: prompt tokens this step's admissions served straight from the
    #: prefix cache (None: engine has no prefix cache) — 0 on a step
    #: that admitted cold prompts is the COLD-MISS signal explain_tail
    #: surfaces when such a step stalls a token
    prefix_hit_tokens: int | None = None
    cached_blocks: int | None = None   # LRU cached-pool size at dispatch
    #: token rows per slot this dispatch may drain in ONE readout sync
    #: (the multi-step decode stride; legacy horizon scans and spec
    #: verify windows report their row count here too). 1 = the
    #: classic one-token-per-slot step.
    readout_stride: int = 1
    #: per-slot TENANT ids of this dispatch: ((slot, adapter_id), ...)
    #: for every resident non-base slot — empty on a single-tenant step
    adapter_slots: tuple = ()
    #: adapter device-cache swap-ins that rode this step's admission
    #: (host factor upload) — the explain_tail "adapter_swap" signal
    adapter_swaps: int = 0
    #: speculative verify accounting, completed at readout: drafts this
    #: step committed vs drafts it rolled back (0/0 on non-spec steps).
    #: The per-slot verify grants themselves ride ``grants`` with kind
    #: "verify" and report their window rows through readout_stride.
    spec_accepted: int = 0
    spec_rejected: int = 0
    #: quantized-KV capacity facts (None on dense engines): total pool
    #: bytes (payload + per-block quantization scales) and the pool
    #: storage dtype ("bf16"/"float32" unquantized, "int8"/"int4" under
    #: kv_cache_dtype) — what joins a preemption-churn tail back to
    #: "the pool was simply small for this dtype"
    kv_pool_bytes: int | None = None
    kv_cache_dtype: str | None = None
    #: host KV tier PREEMPTION-SWAP traffic THIS step moved (None on
    #: dense engines; 0 with the tier off): swap-in restores at the
    #: step's scheduling, swap-outs at its preemptions — the exclusive
    #: signal splitting the preemption tail cause into preempt_swap vs
    #: preempt_reprefill (spill/promote traffic deliberately books on
    #: its own counters so an unrelated eviction on a preemption step
    #: cannot fake the cheap path) — plus the host spill store's block
    #: count at dispatch
    kv_swap_in_bytes: int | None = None
    kv_swap_out_bytes: int | None = None
    kv_host_spill_blocks: int | None = None
    #: cross-replica ship traffic THIS step moved (disaggregated
    #: serving: staged-entry import restores / finish-site exports +
    #: pull-on-miss prefix blocks) — separate from the swap bytes so
    #: the preemption classifier's signal stays exclusive; the
    #: explain_tail "kv_ship" cause reads these
    kv_ship_in_bytes: int | None = None
    kv_ship_out_bytes: int | None = None

    @property
    def budget_utilization(self):
        """tokens_scheduled / token_budget. MAY exceed 1.0: the fused
        scheduler never throttles decode tokens or the oldest ramp's
        progress-guarantee token, so a throttled ``max_step_tokens``
        below the live decode count over-grants — a >1 reading IS the
        signal that the budget is too small to bound interference."""
        return self.tokens_scheduled / self.token_budget \
            if self.token_budget else 0.0

    @property
    def prefill_tokens(self):
        # "embed" grants are prefill-only work and interfere with decode
        # latency exactly like generation ramp-in chunks
        return sum(n for _, _, kind, n in self.grants
                   if kind in ("prefill", "embed"))

    @property
    def decode_slots(self):
        # "verify" grants are decode-side work (a speculative slot's
        # committed token + drafts ride one grant)
        return sum(1 for _, _, kind, _ in self.grants
                   if kind in ("decode", "verify"))

    @property
    def wall_s(self):
        return max(self.t_finish - self.t_begin, 0.0) \
            if self.t_finish else self.dispatch_s

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["grants"] = [list(g) for g in self.grants]
        d["preemptions"] = list(self.preemptions)
        d["finished"] = list(self.finished)
        d["adapter_slots"] = [list(a) for a in self.adapter_slots]
        d["budget_utilization"] = round(self.budget_utilization, 4)
        d["prefill_tokens"] = self.prefill_tokens
        return d


#: one timeline event: (kind, t, step_id, value) — value is the token's
#: inter-token gap ("token"), the chunk's token count ("prefill"), or the
#: finish reason ("finish"); None otherwise. A plain tuple keeps the
#: per-token append allocation-minimal.
_EVENT_FIELDS = ("kind", "t", "step_id", "value")


class _RequestTrace:
    __slots__ = ("request_id", "events", "last_token_t", "prefix_hit",
                 "routing", "trace_ctx")

    def __init__(self, request_id):
        self.request_id = request_id
        self.events = []
        self.last_token_t = None
        #: cached-prefix tokens this request's admission served from the
        #: prefix cache (None until a "cached_prefix" event lands) — what
        #: explain_tail joins prefill-grant interference back to
        self.prefix_hit = None
        #: the placement metadata a "routed" event carried (the replica
        #: router's decision) — explain_tail surfaces it on tail entries
        self.routing = None
        #: the distributed trace context this timeline ran under (dict:
        #: trace_id/hop/parent/via) — the cross-replica join key the
        #: merged-trace stitcher and the router's fleet explain_tail
        #: group per-hop timelines by
        self.trace_ctx = None

    def to_dict(self):
        d = {"request_id": self.request_id,
             "events": [dict(zip(_EVENT_FIELDS, e))
                        for e in self.events]}
        if self.trace_ctx is not None:
            d["trace_ctx"] = dict(self.trace_ctx)
        return d


class FlightRecorder:
    """Fixed-size flight recorder for one engine (+ its server).

    Writers: the engine thread (step records, token/prefill events) and
    submitter threads ("queued" events). One lock guards the request
    dict and the ring slots; every hook takes it at most once and does
    O(1) work inside, so the recorder stays lock-cheap on the serve hot
    path. ``enabled=False`` (or detaching the recorder) short-circuits
    every hook to a single attribute check."""

    def __init__(self, capacity=4096, max_requests=2048, enabled=True,
                 replica=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.max_requests = int(max_requests)
        self.enabled = bool(enabled)
        #: replica/rank index in a multi-replica cluster: chrome-trace
        #: exports use it as the process id + process_name, so per-
        #: replica traces land in distinct lane groups and merge cleanly
        #: (merge_profile re-pids per file; the name survives). None =
        #: single-engine (os.getpid() lanes, unchanged).
        self.replica = replica
        self._ring: list[StepRecord | None] = [None] * self.capacity
        self._seq = 0                      # next step id
        self._lock = threading.Lock()
        self._live: dict[int, _RequestTrace] = {}
        self._done: collections.OrderedDict[int, _RequestTrace] = \
            collections.OrderedDict()
        #: step subscribers (the live pathology detectors): called with
        #: each COMPLETED StepRecord after finish_step, outside the
        #: recorder lock (a subscriber may take store/telemetry locks).
        #: Empty-list check is the only cost when nobody subscribes.
        self._subs = []

    # -- step subscribers (live detectors) ------------------------------
    def subscribe(self, fn):
        """Register ``fn(record)`` to run after every completed step —
        the live pathology detectors' feed. Runs on the engine thread;
        a raising subscriber is dropped from the next notification only
        by its own removal — exceptions are swallowed so a detector bug
        can never crash the serve loop."""
        self._subs.append(fn)
        return fn

    def unsubscribe(self, fn):
        try:
            self._subs.remove(fn)
        except ValueError:
            pass

    # -- step records (engine thread) -----------------------------------
    def next_step_id(self):
        """The id the next ``begin_step`` will assign — lets legacy
        admission stamp its prefill spans with the step that follows."""
        return self._seq

    def begin_step(self, *, scheduler, kind, grants, tokens_scheduled,
                   token_budget, queue_depth, free_blocks, total_blocks,
                   pipeline_inflight, preemptions, admit_s, schedule_s,
                   dispatch_s, t_begin, prefix_hit_tokens=None,
                   cached_blocks=None, readout_stride=1,
                   adapter_slots=(), adapter_swaps=0, kv_pool_bytes=None,
                   kv_cache_dtype=None, kv_swap_in_bytes=None,
                   kv_swap_out_bytes=None, kv_host_spill_blocks=None,
                   kv_ship_in_bytes=None, kv_ship_out_bytes=None):
        """Record one dispatched step; returns its step id."""
        with self._lock:
            sid = self._seq
            self._seq += 1
            self._ring[sid % self.capacity] = StepRecord(
                sid, t_begin, scheduler, kind, tuple(grants),
                int(tokens_scheduled), int(token_budget), int(queue_depth),
                free_blocks, total_blocks, int(pipeline_inflight),
                tuple(preemptions), admit_s, schedule_s, dispatch_s,
                prefix_hit_tokens=prefix_hit_tokens,
                cached_blocks=cached_blocks,
                readout_stride=int(readout_stride),
                adapter_slots=tuple(adapter_slots),
                adapter_swaps=int(adapter_swaps),
                kv_pool_bytes=kv_pool_bytes,
                kv_cache_dtype=kv_cache_dtype,
                kv_swap_in_bytes=kv_swap_in_bytes,
                kv_swap_out_bytes=kv_swap_out_bytes,
                kv_host_spill_blocks=kv_host_spill_blocks,
                kv_ship_in_bytes=kv_ship_in_bytes,
                kv_ship_out_bytes=kv_ship_out_bytes)
            return sid

    def finish_step(self, step_id, sync_s, emit_s, finished=(),
                    spec_accepted=0, spec_rejected=0):
        with self._lock:
            rec = self._ring[step_id % self.capacity]
            if rec is None or rec.step_id != step_id:
                return  # evicted by ring wrap between begin and finish
            rec.t_finish = time.perf_counter()
            rec.sync_s = sync_s
            rec.emit_s = emit_s
            rec.finished = tuple(finished)
            rec.spec_accepted = int(spec_accepted)
            rec.spec_rejected = int(spec_rejected)
        if self._subs:
            # OUTSIDE the recorder lock: subscribers (detectors) take
            # store/telemetry locks of their own, and nothing here may
            # deadlock or crash the engine thread
            for fn in tuple(self._subs):
                try:
                    fn(rec)
                except Exception:
                    pass

    def get_step(self, step_id):
        with self._lock:
            rec = self._ring[step_id % self.capacity]
            return rec if rec is not None and rec.step_id == step_id \
                else None

    def records(self):
        """The retained StepRecords, oldest first."""
        with self._lock:
            lo = max(0, self._seq - self.capacity)
            out = []
            for sid in range(lo, self._seq):
                rec = self._ring[sid % self.capacity]
                if rec is not None and rec.step_id == sid:
                    out.append(rec)
            return out

    def last_record(self):
        with self._lock:
            if not self._seq:
                return None
            rec = self._ring[(self._seq - 1) % self.capacity]
            return rec if rec is not None else None

    # -- request timelines ----------------------------------------------
    def _trace(self, rid, fresh=False):
        if not fresh:
            tr = self._live.get(rid)
            if tr is None:
                tr = self._done.get(rid)
            if tr is not None:
                return tr
        # first sighting — or a FRESH lifecycle ("queued"): request ids
        # restart per server, so a reused id must start a new timeline,
        # not resurrect the finished trace (whose stale last_token_t
        # would fabricate a giant phantom gap)
        self._done.pop(rid, None)
        tr = self._live[rid] = _RequestTrace(rid)
        if len(self._live) > self.max_requests:
            # bound _live too: a recorder attached directly to an
            # engine (no server, so no "finish" events) must not
            # grow without bound over a long-lived serve — demote
            # the oldest live trace to the bounded done set
            old_rid = next(iter(self._live))
            self._done[old_rid] = self._live.pop(old_rid)
            while len(self._done) > self.max_requests:
                self._done.popitem(last=False)
        return tr

    def req_event(self, rid, kind, step_id=None, value=None, t=None):
        """Append one lifecycle span event ("queued", "admitted",
        "prefill", "finish", ...) to request ``rid``'s timeline."""
        if not self.enabled:
            return
        if t is None:
            t = time.perf_counter()
        with self._lock:
            tr = self._trace(rid, fresh=(kind == "queued"))
            tr.events.append((kind, t, step_id, value))
            if kind == "cached_prefix":
                tr.prefix_hit = value
            if kind == "routed":
                tr.routing = value
            if kind == "finish":
                self._live.pop(rid, None)
                self._done[rid] = tr
                while len(self._done) > self.max_requests:
                    self._done.popitem(last=False)

    def set_trace_ctx(self, rid, ctx):
        """Stamp request ``rid``'s timeline with its distributed trace
        context (a TraceContext or its dict form). Called once per
        timeline, right after the "queued" event starts it — the stamp
        is what lets the merged cross-replica export group this lane
        with the same request's lanes on OTHER replicas."""
        if not self.enabled or ctx is None:
            return
        d = ctx if isinstance(ctx, dict) else ctx.to_dict()
        with self._lock:
            self._trace(rid).trace_ctx = dict(d)

    def on_token(self, rid, step_id, t=None):
        """Record one emitted token: its wall time, the id of the step
        whose readout produced it, and the gap since the request's
        previous token. THE per-token hot path — one lock, one tuple
        append. ``t``: an explicit stamp (the engine passes the token's
        AMORTIZED device-step-boundary time for multi-step readouts so
        a k-token burst doesn't read as one giant gap); stamps are
        clamped monotonic per request — pipelined strides may backdate
        into the previous readout's window."""
        if not self.enabled:
            return
        if t is None:
            t = time.perf_counter()
        with self._lock:
            tr = self._trace(rid)
            if tr.last_token_t is not None and t < tr.last_token_t:
                t = tr.last_token_t
            gap = t - tr.last_token_t if tr.last_token_t is not None \
                else None
            tr.last_token_t = t
            tr.events.append(("token", t, step_id, gap))

    def request_trace(self, rid):
        """JSON-ready timeline for one request (None if never seen or
        evicted)."""
        with self._lock:
            tr = self._live.get(rid) or self._done.get(rid)
            return tr.to_dict() if tr is not None else None

    def timelines(self):
        with self._lock:
            out = {}
            for src in (self._done, self._live):
                for rid, tr in src.items():
                    out[rid] = tr.to_dict()
            return out

    # -- exports --------------------------------------------------------
    def export_chrome_trace(self, path):
        """Write a chrome://tracing / Perfetto-loadable JSON: an
        engine-step lane (tid 0) with one span per StepRecord, plus one
        lane per request whose spans run from each timeline event's
        predecessor to the event itself ("queued" wait, "admitted",
        per-chunk "prefill[n]", per-token "token" gaps, "finish").
        Timestamps are perf_counter µs in the chrome ``traceEvents``
        schema, so ``merge_profile`` can merge these across ranks."""
        pid = os.getpid() if self.replica is None else int(self.replica)
        events = []
        if self.replica is not None:
            # one lane GROUP per replica: the pid separates the groups
            # and the process_name labels them (merge_profile keeps the
            # label when it re-pids per merged file)
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": f"replica {self.replica}"}})
        # PIPELINED steps overlap in time (step N+1 dispatches before
        # step N's sync), and same-tid 'X' events must nest properly —
        # pack overlapping step spans onto greedy sub-lanes (depth 2
        # needs exactly 2; requests live at tid >= 100)
        lane_ends = []
        for rec in self.records():
            t0 = rec.t_begin * 1e6
            dur = max(rec.wall_s * 1e6, 1.0)
            for lane, end in enumerate(lane_ends):
                if t0 >= end:
                    break
            else:
                lane = len(lane_ends)
                lane_ends.append(0.0)
            lane_ends[lane] = t0 + dur
            events.append({
                "ph": "X", "cat": "engine", "pid": pid, "tid": lane,
                "name": f"step {rec.step_id} [{rec.kind}]",
                "ts": t0, "dur": dur,
                "args": rec.to_dict()})
            # Perfetto COUNTER tracks ("ph": "C") — per-step load
            # context rendered as line charts UNDER the request lanes:
            # queue depth, pool occupancy, budget utilization, and the
            # speculative acceptance rate. One sample per StepRecord at
            # its dispatch time; series the record cannot source (dense
            # pools, non-spec steps) emit nothing rather than zeros.
            events.append({"ph": "C", "pid": pid, "name": "queue_depth",
                           "ts": t0,
                           "args": {"value": rec.queue_depth}})
            events.append({"ph": "C", "pid": pid,
                           "name": "token_budget_utilization", "ts": t0,
                           "args": {"value": round(
                               rec.budget_utilization, 4)}})
            if rec.total_blocks:
                occ = 1.0 - rec.free_blocks / rec.total_blocks
                events.append({"ph": "C", "pid": pid,
                               "name": "kv_pool_occupancy", "ts": t0,
                               "args": {"value": round(occ, 4)}})
            verified = rec.spec_accepted + rec.spec_rejected
            if verified:
                events.append({"ph": "C", "pid": pid,
                               "name": "spec_acceptance_rate", "ts": t0,
                               "args": {"value": round(
                                   rec.spec_accepted / verified, 4)}})
        for lane in range(max(len(lane_ends), 1)):
            events.append({
                "ph": "M", "pid": pid, "tid": lane, "name": "thread_name",
                "args": {"name": "engine steps" if lane == 0
                         else f"engine steps (pipelined +{lane})"}})
        for rid, tl in sorted(self.timelines().items()):
            tid = 100 + int(rid)  # tids < 100 are engine sub-lanes
            tc = tl.get("trace_ctx")
            lane = f"req {rid}" if tc is None else \
                f"req {rid} [{tc['trace_id']}/{tc['hop']}]"
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": lane}})
            prev_t = None
            for ev in tl["events"]:
                t_us = ev["t"] * 1e6
                start = prev_t if prev_t is not None else t_us
                name = ev["kind"]
                if name == "prefill":
                    name = f"prefill[{ev['value']}]"
                elif name == "cached_prefix":
                    name = f"cached_prefix[{ev['value']}]"
                elif name == "finish":
                    name = f"finish:{ev['value']}"
                args = {}
                if ev["step_id"] is not None:
                    args["step_id"] = ev["step_id"]
                if ev["kind"] == "token" and ev["value"] is not None:
                    args["gap_ms"] = round(ev["value"] * 1e3, 3)
                if ev["kind"] == "routed" and isinstance(ev["value"], dict):
                    args["routing"] = ev["value"]
                if tc is not None:
                    # every request-lane span carries its trace identity
                    # so the merged-trace stitcher can group lanes by
                    # trace_id WITHOUT re-reading recorder state (the
                    # merged file is all it has)
                    args["trace_id"] = tc["trace_id"]
                    args["trace_hop"] = tc["hop"]
                events.append({
                    "ph": "X", "cat": "request", "pid": pid, "tid": tid,
                    "name": name, "ts": start,
                    "dur": max(t_us - start, 1.0), "args": args})
                prev_t = t_us
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return path

    # -- the slow-token explainer ---------------------------------------
    def explain_tail(self, quantile=0.99, top=None):
        """Join the worst inter-token gaps back to their causal
        StepRecord and name the dominant cause.

        Returns a list (worst gap first) of dicts: ``request_id``,
        ``gap_s``, ``step_id``, ``cause`` (one of :data:`TAIL_CAUSES`),
        and ``step`` (the record's facts, None when the ring evicted
        it). Cause taxonomy, checked in order against the step that
        emitted the token:

        * ``preempt_swap`` / ``preempt_reprefill`` — the step carried
          pool-pressure preemptions, split by whether the evicted KV
          moved through the host tier (swap bytes on the step) or was
          recomputed from scratch;
        * ``interfering_prefill`` — prefill work delayed the token: a
          chunk grant rode the same fused dispatch (Sarathi's per-step
          interference), or a legacy admission prefill train ran inside
          the step's ``admit_s`` split;
        * ``draft_rejected`` — the step's speculative verify windows
          rolled back more drafts than they committed: an acceptance
          stall (the adaptive-k EWMA should be shrinking the window),
          not a host-sync pathology;
        * ``batched_readout`` — the sync dominated but the step drained
          a multi-row token burst (``readout_stride > 1``: a multi-step
          stride, a legacy horizon scan, or spec verify windows): the
          gap is the amortized readout boundary working as designed
          (tune the stride/horizon, not the host);
        * ``host_sync`` — the device→host token sync dominated the step;
        * ``idle_bubble`` — the gap is mostly time OUTSIDE the step
          (the engine wasn't dispatching: admission trains, depth-1
          pipeline bubbles, loop stalls);
        * ``dispatch`` — the step's own device compute explains the gap.
        """
        gaps = []
        for rid, tl in self.timelines().items():
            # a token whose gap spans a supervised restart ("crashed"
            # span since the previous token) is a RECOVERY gap — its
            # causal step record describes the resumed engine, not the
            # stall, so it gets the dedicated cause label
            crashed_since = False
            for ev in tl["events"]:
                if ev["kind"] == "crashed":
                    crashed_since = True
                elif ev["kind"] == "token" and ev["value"] is not None:
                    gaps.append((ev["value"], rid, ev["step_id"],
                                 crashed_since))
                    crashed_since = False
                elif ev["kind"] == "token":
                    crashed_since = False
        if not gaps:
            return []
        ordered = sorted(g[0] for g in gaps)
        thresh = ordered[min(int(quantile * len(ordered)),
                             len(ordered) - 1)]
        tail = sorted((g for g in gaps if g[0] >= thresh), reverse=True)
        if top is not None:
            tail = tail[:top]
        out = []
        for gap, rid, sid, recovered in tail:
            rec = self.get_step(sid) if sid is not None else None
            cause = "restart_recovery" if recovered \
                else self._classify(gap, rec)
            entry = {"request_id": rid, "gap_s": round(gap, 6),
                     "step_id": sid, "cause": cause,
                     "step": rec.to_dict() if rec is not None else None}
            with self._lock:
                tr = self._live.get(rid) or self._done.get(rid)
                routing = tr.routing if tr is not None else None
                trace_ctx = tr.trace_ctx if tr is not None else None
            if trace_ctx is not None:
                entry["trace_id"] = trace_ctx["trace_id"]
            if routing is not None:
                # the router's placement record for THIS request — which
                # replica/score/affinity put the slow token where it ran
                entry["routing"] = routing
            if rec is not None and rec.prefix_hit_tokens is not None \
                    and cause == "interfering_prefill":
                # prefix cache was on and this gap came from prefill
                # interference: name whether any interfering REQUEST was
                # a COLD MISS (an admission the cache served nothing of).
                # Joined through the granted requests' own cached_prefix
                # records — the step's hit delta alone would mislabel
                # the later chunk grants of a partially-served prompt
                # (they ride steps whose own delta is 0)
                pre_rids = [g[1] for g in rec.grants if g[2] == "prefill"]
                if pre_rids:
                    with self._lock:
                        traces = [self._live.get(r) or self._done.get(r)
                                  for r in pre_rids]
                    entry["cold_miss"] = any(
                        tr is None or not tr.prefix_hit for tr in traces)
                else:
                    # legacy admit-train shape (no grants recorded):
                    # join through the prefill spans stamped with THIS
                    # step's id — one legacy step may admit several
                    # requests (cold and cache-served mixed in one
                    # train), so the step's own hit delta alone could
                    # hide a cold admission behind another's hit. Falls
                    # back to the delta when the timelines were evicted.
                    with self._lock:
                        hits = [tr.prefix_hit
                                for src in (self._live, self._done)
                                for tr in src.values()
                                if any(e[0] == "prefill" and e[2] == sid
                                       for e in tr.events)]
                    entry["cold_miss"] = any(not h for h in hits) \
                        if hits else rec.prefix_hit_tokens == 0
            out.append(entry)
        return out

    def classify_token_gap(self, rid, step_id, gap_s):
        """Classify ONE inter-token gap against its causal StepRecord —
        the single-gap form of :meth:`explain_tail`, for callers (the
        router's fleet-level tail join) that assemble END-TO-END gap
        lists across recorders and only need this recorder's verdict
        for a gap that stayed inside it. Returns ``(cause, record)``
        with record None when the ring evicted the step."""
        rec = self.get_step(step_id) if step_id is not None else None
        return self._classify(gap_s, rec), rec

    @staticmethod
    def _classify(gap, rec):
        if rec is None:
            return "unrecorded"
        if rec.preemptions:
            # split by the host KV tier's involvement: any tier traffic
            # on the step (swap-out at the preemption, or a swap-in
            # restore riding the same step's re-admission) means the
            # evicted KV moved through host RAM instead of being
            # recomputed — the cheap path, as opposed to the full
            # re-prefill the tier exists to remove
            if getattr(rec, "kv_swap_out_bytes", None) or \
                    getattr(rec, "kv_swap_in_bytes", None):
                return "preempt_swap"
            return "preempt_reprefill"
        if getattr(rec, "adapter_swaps", 0):
            # the step's admission swapped adapter factors onto the
            # device — a multi-tenant working set bigger than the
            # adapter cache, distinct from ordinary prefill ramp-in
            return "adapter_swap"
        if getattr(rec, "kv_ship_in_bytes", None) or \
                getattr(rec, "kv_ship_out_bytes", None):
            # cross-replica ship traffic rode this step (a migrated
            # request's import scattering in with its stitch grant, or
            # an export staging out at a finish) — checked BEFORE the
            # prefill-interference test because the stitch grant rides
            # a mixed step and would otherwise file there
            return "kv_ship"
        wall = rec.wall_s
        # prefill interference comes in two shapes: a fused chunk grant
        # in the step's own dispatch (grants), or a legacy admission
        # prefill train run inside step_begin (admit_s dominates the
        # wall — the single most common legacy stall)
        if rec.prefill_tokens > 0 or (wall > 0 and
                                      rec.admit_s >= 0.5 * wall):
            return "interfering_prefill"
        # rejection-stall refinement: only where the STEP ITSELF explains
        # the gap (sync- or dispatch-dominated below — never an idle
        # bubble, whose wall lies outside the step) AND a strict
        # majority of the step's verify work rolled back does the
        # rejected speculation own the verdict. Healthy-acceptance spec
        # steps keep the host_sync/batched_readout taxonomy.
        rejection_stall = getattr(rec, "spec_rejected", 0) > \
            getattr(rec, "spec_accepted", 0)
        if wall > 0 and rec.sync_s >= 0.5 * wall:
            if rejection_stall:
                # the sync drained windows that mostly rolled back: the
                # wall went to verifying tokens that never committed —
                # an acceptance stall, NOT the host-sync pathology the
                # share heuristic would otherwise file it as
                return "draft_rejected"
            # a sync-dominated step whose readout drained a k-row burst
            # (stride, horizon scan, or spec verify windows) is the
            # BATCHED readout boundary, not a host-sync pathology — one
            # sync amortized over k rows per slot is exactly what those
            # amortization knobs are for
            if rec.readout_stride > 1:
                return "batched_readout"
            return "host_sync"
        if gap - wall > max(wall, 1e-9):
            return "idle_bubble"
        if rejection_stall:
            # dispatch-dominated verify step, majority rolled back: the
            # device compute was spent on rejected drafts
            return "draft_rejected"
        return "dispatch"

    def snapshot(self, tail=None):
        """JSON-ready summary: retained step counts + cause histogram of
        the current 0.99 tail (cheap enough to ride in bench output).
        Pass a precomputed ``explain_tail`` result as ``tail`` to avoid
        re-walking the timelines."""
        recs = self.records()
        if tail is None:
            tail = self.explain_tail(0.99, top=64)
        causes = collections.Counter(e["cause"] for e in tail)
        return {"steps_recorded": len(recs),
                "steps_total": self._seq,
                "ring_capacity": self.capacity,
                "requests_tracked": len(self._live) + len(self._done),
                "tail_causes_p99": dict(causes)}
