"""AsyncLLMServer — the serving loop over one :class:`LLMEngine`
(counterpart: ``paddle_tpu/serving/server.py``).

The engine thread runs a PIPELINED loop::

    dispatch step N+1  ──►  the card works on N+1
    sync step N's token row (device→host)   ← overlapped with N+1
    emit tokens / retire / admit

so the host-side readout and request bookkeeping of step N hide under the
device work of step N+1 (``LLMEngine.step_begin``/``step_finish``: CUDA
launches return before the card finishes, and ``step_finish`` waits on
the step's own event). The depth is ``min(pipeline_depth or 2,
engine.max_pipeline_depth())``: a fused engine (dense, or paged on a full
pool) and a dense legacy one take 2 (the fused one 3 on request), a
legacy paged one 1.

On top of the loop sit the two serving layers the engine does not have:

* **request lifecycle** — a bounded admission queue with backpressure
  (:class:`~paddle_tpu_torch.serving.scheduler.AdmissionQueue`),
  per-request streaming handles
  (:class:`~paddle_tpu_torch.serving.types.RequestHandle`), cancellation
  and deadlines that free the slot and its pool blocks at the next step
  boundary, and optional deadline-aware shedding;
* **per-stage telemetry**
  (:class:`~paddle_tpu_torch.profiler.serving_telemetry.ServingTelemetry`):
  every second of engine-thread wall time lands in a named stage, plus
  TTFT, inter-token, e2e, queue-wait and admission-stall histograms, as
  a JSON snapshot and a Prometheus text dump;

and fault tolerance: ``supervise=RestartPolicy`` crash recovery (reset
the engine, re-admit every in-flight request as prompt⊕streamed tokens,
token-exact for greedy streams), the heartbeat watchdog
(``step_timeout_s``) and a scripted ``FaultInjector``.

Observability beyond the telemetry, as in the reference: a
:class:`~paddle_tpu_torch.profiler.FlightRecorder` (``flight_recorder=``)
attached to the engine for the server's life, with the server's
request-timeline events (queued, routed, admitted, crashed, resumed,
finish), and a :class:`~paddle_tpu_torch.profiler.MetricsStore`
(``metrics_store=``) fed every gauge and counter each
``metrics_interval_s`` plus every TTFT, inter-token, queue-wait and e2e
sample.

Not in this port yet (ROADMAP A11): SLOs, pathology detectors and the
black box. Each constructor argument defaults to None and raises
``NotImplementedError`` when given, as do :meth:`dump_debug_bundle` and
:meth:`slo_report`; so does the recorder-plus-store combination with
``pathology_detectors=None``, where the reference arms its default
detectors.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from ..analysis import lock_watchdog as _lockwatch
from ..inference.llm_engine import PoolCapacityError
from ..profiler.flight_recorder import FlightRecorder
from ..profiler.metrics_store import MetricsStore
from ..profiler.serving_telemetry import ServingTelemetry
from .scheduler import AdmissionQueue
from .types import (RequestHandle, RequestState, ServeRequest, ServeResult,
                    ServerClosed, TraceContext)

__all__ = ["AsyncLLMServer"]

#: engine stats of the prefix cache and the host KV tier (swap-outs,
#: spills and restores all happen inside step_begin), booked as
#: telemetry counters
_PREFIX_COUNTERS = ("prefix_hit_tokens", "prefix_cow_blocks",
                    "prefix_evicted_blocks", "kv_swap_out_blocks",
                    "kv_swap_in_blocks", "kv_swap_saved_tokens",
                    "kv_spill_blocks", "kv_promote_blocks")
#: engine stats of speculation, booked as telemetry counters at readout
_SPEC_COUNTERS = ("spec_proposed_tokens", "spec_accepted_tokens")


def _a11(what):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP A11")


class AsyncLLMServer:
    """Async serving facade over one :class:`LLMEngine`.

    The server OWNS the engine once started: every engine call happens on
    the background engine thread; callers interact only through
    :meth:`submit` handles.

    Usage::

        server = AsyncLLMServer(engine, max_queue_size=64)
        server.start()
        handle = server.submit(prompt_ids, max_new_tokens=64,
                               deadline_s=30.0)
        for tok in handle:          # streams as the engine decodes
            ...
        result = handle.result()    # ServeResult(finish_reason=...)
        server.stop()
    """

    def __init__(self, engine, max_queue_size=64, pipeline_depth=None,
                 poll_interval_s=0.005, telemetry=None,
                 flight_recorder=None, replica=None, supervise=None,
                 step_timeout_s=None, fault_injector=None,
                 shed_deadlines=False, metrics_store=None, slos=None,
                 pathology_detectors=None, metrics_interval_s=0.05,
                 slo_interval_s=0.25, black_box=None,
                 trace_context=True):
        """``replica``: this server's index among replicas, stamped as a
        ``replica`` label on every Prometheus line. None = single server.

        ``supervise``: a :class:`~paddle_tpu_torch.serving.RestartPolicy`
        arms SUPERVISED recovery: a serving-loop crash resets the engine
        and re-admits every in-flight request as prompt⊕tokens-streamed,
        so its stream CONTINUES token-exactly (greedy). Restarts are
        bounded with exponential backoff; an exhausted policy fails every
        waiter with ``finish_reason="server_error"`` carrying its partial
        tokens, exactly like the unsupervised (None) path.

        ``step_timeout_s``: arms the WATCHDOG: the loop stamps a heartbeat
        every pass; a watchdog thread flips the ``server_healthy`` gauge
        to 0 (and :meth:`health` to ``"hung"``) once it goes stale by more
        than this, and interrupts an attached FaultInjector's
        interruptible hang. Set it above the worst legitimate step.

        ``fault_injector``: a :class:`~paddle_tpu_torch.serving
        .FaultInjector` scripted chaos schedule, attached to the engine
        for the server's lifetime (tests only).

        ``shed_deadlines``: deadline-aware load shedding (off by default):
        a request whose ``deadline_s`` is below the telemetry-estimated
        queue wait + TTFT finishes ``"deadline"`` at submit or admission,
        before its prefill runs.

        ``trace_context``: mint a TraceContext per submitted request.

        ``flight_recorder``: a :class:`~paddle_tpu_torch.profiler
        .FlightRecorder` (``True`` builds one for ``replica``), attached
        to the engine from :meth:`start` to :meth:`stop`: one StepRecord
        per engine step, each token stamped with its step id, and the
        server's request events; finished results carry their timeline
        (``ServeResult.trace``).

        ``metrics_store``: a :class:`~paddle_tpu_torch.profiler
        .MetricsStore` (``True`` builds one): every gauge and counter
        each ``metrics_interval_s`` seconds, and every TTFT, inter-token,
        queue-wait and e2e sample per tenant.

        ``slos``, ``pathology_detectors``, ``black_box`` (with
        ``slo_interval_s``) belong to ROADMAP A11: None (the default)
        works, anything else raises, and so does a recorder with a store
        while ``pathology_detectors`` is None (the reference then arms
        its default detectors); ``False`` declines them."""
        if slos:
            _a11("slos")
        if pathology_detectors:
            _a11("pathology_detectors")
        if black_box:
            _a11("black_box")
        if pipeline_depth is not None and pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, "
                             f"got {pipeline_depth}")
        self.replica = replica
        if flight_recorder is True:
            flight_recorder = FlightRecorder(replica=replica)
        if flight_recorder is not None and replica is not None \
                and flight_recorder.replica is None:
            flight_recorder.replica = replica
        self.flight_recorder = flight_recorder or None
        if metrics_store is True:
            metrics_store = MetricsStore()
        self.metrics_store = metrics_store or None
        if pathology_detectors is None and self.metrics_store is not None \
                and self.flight_recorder is not None:
            _a11("the default pathology detectors (a flight recorder with "
                 "a metrics store arms them; pass pathology_detectors="
                 "False to serve without)")
        self.metrics_interval_s = float(metrics_interval_s)
        self._ms_last_t = 0.0       # metrics-store feed throttle
        self.engine = engine
        # the engine knows its safe depth (LLMEngine.max_pipeline_depth);
        # the DEFAULT stays 2 and deeper pipelining is an explicit opt-in
        self.pipeline_depth = min(int(pipeline_depth or 2),
                                  engine.max_pipeline_depth())
        self.poll_interval_s = float(poll_interval_s)
        self.telemetry = telemetry or ServingTelemetry(replica=replica)
        if replica is not None and self.telemetry.replica is None:
            self.telemetry.replica = replica
        self._queue = AdmissionQueue(max_queue_size)
        self._handles: dict[int, RequestHandle] = {}
        # PADDLE_TPU_LOCK_CHECKS=1: acquisition edges feed the lock-order
        # watchdog (paddle_tpu_torch.analysis.lock_watchdog)
        self._hlock = _lockwatch.tracked(threading.Lock(),
                                         "AsyncLLMServer._hlock")
        self._next_id = 0
        #: last engine-stat values the kv_ship telemetry counters have
        #: absorbed: ship bookings come from two threads (the engine's and
        #: the router's pull-on-miss export), so they delta-sync in the
        #: gauge update, outside any step window
        self._ship_seen: dict[str, int] = {}
        self._work_evt = threading.Event()
        self._thread = None
        self._accepting = False
        self._stopping = False
        self._crashed = None
        self._saved_callback = None
        self._saved_recorder = None
        # ---- fault tolerance (supervise / watchdog / chaos) ----------
        self.supervise = supervise
        self.step_timeout_s = (float(step_timeout_s)
                               if step_timeout_s is not None else None)
        self.fault_injector = fault_injector
        self.shed_deadlines = bool(shed_deadlines)
        #: mint a TraceContext per submitted request (caller-supplied
        #: contexts are honored either way)
        self.trace_context = bool(trace_context)
        #: restarts consumed this lifetime (reset by start())
        self.restarts = 0
        self._heartbeat = None      # time.monotonic() of the last loop pass
        self._hung = False          # watchdog verdict (loop pass clears it)
        self._recovering = False    # True between a crash and its re-arm
        self._saved_injector = None
        self._wd_stop = threading.Event()
        self._wd_thread = None

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._saved_callback = self.engine.stream_callback
        self.engine.stream_callback = self._on_token
        if self.flight_recorder is not None:
            self._saved_recorder = self.engine.flight_recorder
            self.engine.flight_recorder = self.flight_recorder
        if self.fault_injector is not None:
            self._saved_injector = self.engine.fault_injector
            self.engine.fault_injector = self.fault_injector
            self.fault_injector._telemetry = self.telemetry
        self._accepting = True
        self._stopping = False
        self._crashed = None  # a restarted server starts clean
        self.restarts = 0
        self._heartbeat = None
        self._hung = False
        self._recovering = False
        self.telemetry.reset()
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-tpu-serving",
                                        daemon=True)
        self._thread.start()
        if self.step_timeout_s is not None:
            self._wd_stop.clear()
            self._wd_thread = threading.Thread(
                target=self._watchdog_loop, name="paddle-tpu-watchdog",
                daemon=True)
            self._wd_thread.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop the engine thread. ``drain=True`` serves every accepted
        request to completion first; ``drain=False`` cancels everything
        outstanding.

        A join that times out raises :exc:`TimeoutError` WITHOUT
        detaching anything: the engine thread still owns the engine; a
        second ``stop()`` keeps waiting. A supervised restart already in
        progress is allowed to COMPLETE first."""
        if self._thread is None:
            return
        self._accepting = False
        if not drain:
            with self._hlock:
                handles = list(self._handles.values())
            for h in handles:
                h.cancel_requested = True
        self._stopping = True
        self._wake()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"serving loop did not stop within {timeout}s; still "
                f"draining — call stop() again to keep waiting")
        self._thread = None
        if self._wd_thread is not None:
            self._wd_stop.set()
            self._wd_thread.join()
            self._wd_thread = None
        self.engine.stream_callback = self._saved_callback
        if self.flight_recorder is not None:
            self.engine.flight_recorder = self._saved_recorder
        if self.fault_injector is not None:
            self.engine.fault_injector = self._saved_injector
        if self._crashed is not None:
            raise RuntimeError(
                f"serving loop crashed: {self._crashed}") from self._crashed

    def health(self):
        """Point-in-time health probe, answerable from ANY thread:
        ``"running"`` (healthy), ``"hung"`` (heartbeat stale past
        ``step_timeout_s``), ``"restarting"`` (a supervised recovery is
        between crash and re-arm), ``"crashed"`` (terminal) or
        ``"stopped"``."""
        now = time.monotonic()
        thread = self._thread
        alive = thread is not None and thread.is_alive()
        hb = self._heartbeat
        age = (now - hb) if hb is not None else None
        if self._crashed is not None:
            state = "crashed"
        elif not alive:
            state = "stopped"
        elif self._recovering:
            state = "restarting"
        elif self._hung or (self.step_timeout_s is not None
                            and age is not None
                            and age > self.step_timeout_s):
            state = "hung"
        else:
            state = "running"
        return {"state": state, "healthy": state == "running",
                "heartbeat_age_s": age, "restarts": self.restarts,
                "thread_alive": alive}

    def evict_request(self, request_id, reason="evicted"):
        """Force-finish one request from ANY thread, without the engine
        thread's help: the router's hung-replica failover hook. The handle
        detaches at once (no further token can reach it) and finishes with
        ``finish_reason=reason`` carrying every token emitted so far. The
        engine is NOT touched: if the wedged loop later revives, the zombie
        slot decodes to a finish whose output is dropped (its handle is
        gone) and frees its pool blocks normally. Returns the detached
        handle, or None if unknown or done."""
        with self._hlock:
            h = self._handles.pop(request_id, None)
        if h is None or h.done:
            return None
        self._queue.remove(h)
        self._finish_handle(h, h.full_stream(), reason)
        return h

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False

    def _wake(self):
        self._work_evt.set()

    # -- submission ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=64, temperature=0.0,
               top_p=1.0, eos_token_id=None, deadline_s=None, block=True,
               timeout=None, routing=None, resume_tokens=None,
               readout_stride=None, adapter_id=0,
               kind="generate", spec_ewma=None, request_id=None,
               export_kv=False, trace_ctx=None) -> RequestHandle:
        """Submit one generation request; returns its streaming
        :class:`RequestHandle`.

        Backpressure: a full admission queue blocks (``block=True``, up to
        ``timeout`` seconds) or raises :class:`ServerQueueFull`.
        Validation errors (empty or over-capacity prompt, a prompt the
        pool cannot hold) raise ValueError synchronously. ``deadline_s``
        is a relative budget: once exceeded, the request is cancelled
        wherever it is with finish_reason ``"deadline"``.

        ``routing``: opaque metadata surfaced on ``ServeResult.routing``.
        ``resume_tokens``: tokens this request already streamed elsewhere;
        admission prefills prompt⊕resume_tokens, only new tokens stream,
        and they count against ``max_new_tokens``. ``request_id``: an
        explicit id (rejected if tracked). ``trace_ctx``: the request's
        TraceContext, minted here when absent. ``readout_stride``: a
        latency-tier pin for multi-step decode (1 forces per-step readout
        while the request is resident; None inherits the engine's
        stride). ``spec_ewma``: a carried draft-acceptance EWMA seeding a
        speculative engine's verify windows for this request (a failover
        forwards ``LLMEngine.spec_ewma_for``); None lets the engine learn,
        inert without speculation. ``export_kv``: stage this request's
        committed KV as a shippable entry when it finishes (the router's
        prefill leg; see ``LLMEngine.export_kv``). ``kind="embed"`` and a
        nonzero ``adapter_id`` (A10) are not in this port and raise."""
        if self._crashed is not None:
            raise ServerClosed(
                f"serving loop crashed: {self._crashed}") from self._crashed
        if not self._accepting:
            raise ServerClosed("server is not accepting requests")
        eng = self.engine
        ids = np.asarray(
            prompt_ids.numpy() if hasattr(prompt_ids, "numpy")
            else prompt_ids, dtype=np.int32).reshape(-1)
        resume = [int(t) for t in resume_tokens] if resume_tokens else None
        total = len(ids) + len(resume or [])
        # fail fast on the submitter's thread, mirroring add_request
        if len(ids) == 0:
            raise ValueError("empty prompt")
        adapter_id = int(adapter_id or 0)
        if adapter_id:
            raise ValueError(f"adapter_id {adapter_id} on an engine "
                             f"without an adapter_store")
        if kind not in ("generate", "embed"):
            raise ValueError(f"unknown request kind {kind!r}")
        if kind == "embed":
            raise NotImplementedError(
                "embedding requests are not ported yet: ROADMAP A10")
        if readout_stride is not None and int(readout_stride) < 1:
            raise ValueError(f"readout_stride must be >= 1, got "
                             f"{readout_stride}")
        if total >= eng.capacity - eng.speculative_k:
            raise ValueError(
                f"prompt of {total} tokens leaves no room to "
                f"generate (engine capacity {eng.capacity})")
        if eng.cache_impl == "paged" and \
                eng.prefill_blocks_needed(total) > eng.n_blocks:
            raise ValueError(
                f"prompt of {total} tokens cannot prefill into the "
                f"{eng.n_blocks}-block pool")
        with self._hlock:
            if request_id is not None:
                rid = int(request_id)
                if rid in self._handles:
                    raise ValueError(
                        f"request_id {rid} is already tracked by this "
                        f"server")
                self._next_id = max(self._next_id, rid + 1)
            else:
                rid = self._next_id
                self._next_id += 1
        now = time.monotonic()
        tc = TraceContext.coerce(trace_ctx)
        if tc is None and self.trace_context:
            tc = TraceContext.mint("submit")
        req = ServeRequest(
            rid, ids, int(max_new_tokens), float(temperature), float(top_p),
            eos_token_id,
            deadline=(now + float(deadline_s)
                      if deadline_s is not None else None),
            submitted_at=now,
            routing=dict(routing) if routing is not None else None,
            resume_tokens=resume,
            readout_stride=(int(readout_stride)
                            if readout_stride is not None else None),
            spec_ewma=(float(spec_ewma) if spec_ewma is not None
                       else None),
            export_kv=bool(export_kv), trace_ctx=tc)
        handle = RequestHandle(self, req)
        rec = self.flight_recorder
        if self.shed_deadlines and deadline_s is not None:
            est = self._admission_estimate_s()
            if float(deadline_s) < est:
                # doomed before its prefill would start: shed NOW. Every
                # submitted request finishes exactly once in the counters
                self.telemetry.inc("requests_submitted")
                self.telemetry.inc("requests_shed_deadline")
                self.telemetry.inc("requests_finished")
                shed_e2e = time.monotonic() - now
                self.telemetry.observe("e2e_s", shed_e2e, tenant=adapter_id)
                if self.metrics_store is not None:
                    self.metrics_store.observe("e2e_s", shed_e2e,
                                               tenant=adapter_id)
                if rec is not None:
                    rec.req_event(rid, "queued")
                    rec.set_trace_ctx(rid, tc)
                    rec.req_event(rid, "finish", value="deadline")
                handle._finish(ServeResult(
                    rid, list(resume or []), "deadline", True,
                    e2e_s=0.0, routing=req.routing, trace_ctx=tc))
                return handle
        with self._hlock:
            self._handles[rid] = handle
        if rec is not None:
            # BEFORE the put: once queued, the engine thread may admit it
            # and emit its events, so "queued" must head the timeline
            rec.req_event(rid, "queued")
            rec.set_trace_ctx(rid, tc)
            if req.routing is not None:
                rec.req_event(rid, "routed", value=dict(req.routing))
        try:
            fi = self.fault_injector
            if fi is not None:
                # injected queue_full bursts ride the SAME rejection
                # bookkeeping as a genuinely full queue
                fi.on_submit(self)
            # a failover resume jumps the queue: its consumer is
            # already mid-stream
            self._queue.put(handle, block=block, timeout=timeout,
                            front=resume is not None)
        except Exception:
            with self._hlock:
                self._handles.pop(rid, None)
            self.telemetry.inc("requests_rejected_queue_full")
            if rec is not None:   # terminal: the timeline must not leak
                rec.req_event(rid, "finish", value="rejected_queue_full")
            raise
        if self._stopping or self._crashed is not None:
            # TOCTOU with stop(): the loop may have taken its final look
            # at the queue before our put landed; undo unless picked up
            if self._queue.remove(handle):
                with self._hlock:
                    self._handles.pop(rid, None)
                if rec is not None:
                    rec.req_event(rid, "finish", value="server_stopped")
                raise ServerClosed("server stopped while submitting")
        self.telemetry.inc("requests_submitted")
        self._wake()
        return handle

    def submit_embed(self, prompt_ids, adapter_id=0, deadline_s=None,
                     block=True, timeout=None, routing=None):
        """Prefill-only embedding requests are not ported yet (A10)."""
        raise NotImplementedError(
            "embedding requests are not ported yet: ROADMAP A10")

    def num_outstanding(self):
        with self._hlock:
            return len(self._handles)

    # -- engine thread ---------------------------------------------------
    def _loop(self):
        """The engine thread's outer SUPERVISOR: run the serve loop; on a
        crash either recover (``supervise=``) or fail terminally (every
        waiter gets ``finish_reason="server_error"`` with its partial
        tokens)."""
        while True:
            try:
                self._serve_loop()
                # clean exit: a stopped server must not scrape healthy
                self.telemetry.set_gauge("server_healthy", 0.0)
                return
            except BaseException as e:
                if not self._recover(e):
                    return

    def _serve_loop(self):
        tel = self.telemetry
        # the in-flight dispatch window, oldest first: up to
        # pipeline_depth step_begin()s run ahead of the oldest sync
        pending = collections.deque()
        while True:
            # the watchdog heartbeat: one monotonic read per pass
            self._heartbeat = time.monotonic()
            self._hung = False
            # "other": the loop's own bookkeeping (sweeps, gauges)
            with tel.stage("other"):
                self._sweep_cancels_and_deadlines()
                self._update_gauges()
            with tel.stage("queue_admit"):
                self._feed_engine()
                self._mark_admission_stalls()
            # fill the in-flight window before blocking on the oldest
            # step's token transfer
            while len(pending) < self.pipeline_depth:
                try:
                    nxt = self._begin_step()
                except PoolCapacityError as e:
                    # the head request can never admit (its prompt
                    # outgrew the pool): fail THAT request, not the server
                    self._fail_head_waiting(e)
                    break
                if nxt is None:
                    break
                pending.append(nxt)
            if not pending:
                if self._stopping and not self.num_outstanding() \
                        and len(self._queue) == 0:
                    return
                with tel.stage("idle"):
                    self._work_evt.wait(self.poll_interval_s)
                    self._work_evt.clear()
                continue
            done = self._finish_step(pending.popleft())
            if done:
                with tel.stage("other"):
                    self._handle_done(done)

    def _recover(self, exc):
        """Crash handler. True: the serve loop re-enters (a supervised
        restart within budget). False: terminal (every waiter failed
        attributably)."""
        tel = self.telemetry
        tel.set_gauge("server_healthy", 0.0)
        rec = self.flight_recorder
        pol = self.supervise
        if pol is None or self.restarts >= pol.max_restarts:
            # terminal. _crashed/_accepting flip BEFORE the snapshot, so a
            # racing submit() either raises ServerClosed or is failed here
            self._crashed = exc
            self._accepting = False
            with self._hlock:
                handles = list(self._handles.values())
                self._handles.clear()
            self._queue.drain()
            for h in handles:
                if h.done:
                    continue
                if rec is not None:
                    rec.req_event(h.request_id, "crashed", value=str(exc))
                h._finish(ServeResult(
                    h.request_id, h.full_stream(),
                    f"server_error: {exc}", True,
                    routing=h.request.routing,
                    trace_ctx=h.request.trace_ctx))
            return False
        # ---- supervised restart --------------------------------------
        with self._hlock:
            handles = [h for h in self._handles.values() if not h.done]
        self._recovering = True
        self.restarts += 1
        tel.inc("engine_restarts")
        resident = [h for h in handles
                    if h.state in (RequestState.PENDING,
                                   RequestState.RUNNING)]
        if rec is not None:
            for h in resident:
                rec.req_event(h.request_id, "crashed", value=str(exc))
        # a crash LOOP must not spin the engine thread
        time.sleep(self.supervise.delay(self.restarts))
        try:
            self.engine.reset()
        except BaseException as reset_exc:  # engine unrecoverable
            self._recovering = False
            self.supervise = None   # force the terminal path
            return self._recover(reset_exc)
        # re-admit every engine-resident request as prompt⊕streamed,
        # oldest first (the original admission order)
        for h in sorted(resident, key=lambda h: h.request.request_id):
            committed = h.full_stream()
            if self._readmit(h, committed):
                tel.inc("requests_resumed")
                if rec is not None:
                    rec.req_event(h.request_id, "resumed",
                                  value=len(committed))
        self._recovering = False
        self._wake()
        return True

    def _readmit(self, handle, committed):
        """Hand one request to the engine as prompt⊕``committed`` (tokens
        it already streamed; empty for a fresh admission). A stream that
        already emitted its eos finishes ``"eos"`` here, an exhausted
        budget ``"length"``, one grown to the capacity edge
        ``"capacity"``, and an engine validation error ``"rejected"`` on
        the ``requests_rejected_validation`` counter. Returns True when
        the request entered the engine."""
        req = handle.request
        eng = self.engine
        eos = req.eos_token_id
        if committed and eos is not None and committed[-1] == eos:
            self._finish_handle(handle, committed, "eos")
            return False
        remaining = req.max_new_tokens - len(committed)
        if committed and remaining <= 0:
            self._finish_handle(handle, committed, "length")
            return False
        if committed and len(req.prompt_ids) + len(committed) >= \
                eng.capacity - eng.speculative_k:
            self._finish_handle(handle, committed, "capacity")
            return False
        try:
            self.engine.add_request(
                req.prompt_ids, max_new_tokens=remaining,
                temperature=req.temperature, top_p=req.top_p,
                eos_token_id=eos, request_id=req.request_id,
                committed_tokens=committed or None,
                readout_stride=req.readout_stride,
                spec_ewma=req.spec_ewma,
                export_kv=req.export_kv,
                trace_ctx=req.trace_ctx)
        except ValueError as e:
            self.telemetry.inc("requests_rejected_validation")
            self._finish_handle(handle, committed, f"rejected: {e}")
            return False
        handle.state = RequestState.PENDING
        return True

    def _watchdog_loop(self):
        """Stale-heartbeat monitor (``step_timeout_s``): flips the
        ``server_healthy`` gauge and :meth:`health` to hung, and
        interrupts an attached FaultInjector's interruptible hang."""
        period = min(self.step_timeout_s / 4.0, 0.05)
        while not self._wd_stop.wait(period):
            hb = self._heartbeat
            thread = self._thread
            if (hb is None or self._recovering or self._crashed is not None
                    or thread is None or not thread.is_alive()):
                continue
            if time.monotonic() - hb > self.step_timeout_s \
                    and not self._hung:
                self._hung = True
                self.telemetry.set_gauge("server_healthy", 0.0)
                fi = self.fault_injector
                if fi is not None and fi.hanging:
                    fi.interrupt()

    def _fail_head_waiting(self, err):
        eng = self.engine
        if not eng.waiting:
            raise err  # not a head-of-queue admission failure: re-raise
        req = eng.waiting.popleft()
        # a preemption-grown request may have streamed tokens before it
        # was parked: _finish_tokens stitches them in and pops the stitch
        tokens = eng._finish_tokens(req, [])
        with self._hlock:
            h = self._handles.get(req.request_id)
        if h is not None:
            self._finish_handle(h, tokens, f"rejected: {err}")

    def _begin_step(self):
        """engine.step_begin() with its wall split into the prefill
        (admission) dispatch, the decode dispatch and the host scheduling
        remainder, read back from the engine's own stage stats."""
        eng, tel = self.engine, self.telemetry
        s_admit = eng.stats["admit_time_s"]
        s_disp = eng.stats["dispatch_time_s"]
        s_pre = eng.stats["preemptions"]
        s_ptok = eng.stats["prefill_tokens"]
        s_multi = eng.stats["multi_steps"]
        s_pfx = {k: eng.stats.get(k, 0) for k in _PREFIX_COUNTERS}
        t0 = time.perf_counter()
        pending = eng.step_begin()
        wall = time.perf_counter() - t0
        d_admit = eng.stats["admit_time_s"] - s_admit
        d_disp = eng.stats["dispatch_time_s"] - s_disp
        d_ptok = eng.stats["prefill_tokens"] - s_ptok
        tel.add_stage("prefill_dispatch", d_admit)
        tel.add_stage("decode_dispatch", d_disp)
        tel.add_stage("schedule", max(wall - d_admit - d_disp, 0.0))
        if d_ptok:
            tel.inc("prefill_tokens", d_ptok)
        for key, before in s_pfx.items():
            # prefix-cache hits, COW clones, LRU evictions and the host
            # tier's swaps, spills and restores all happen inside
            # step_begin
            if eng.stats.get(key, 0) > before:
                tel.inc(key, eng.stats[key] - before)
        if eng.stats["preemptions"] > s_pre:
            # pool-pressure preemptions happen inside step_begin
            tel.inc("preemptions", eng.stats["preemptions"] - s_pre)
        if eng.stats["multi_steps"] > s_multi:
            tel.inc("multi_steps", eng.stats["multi_steps"] - s_multi)
        if d_admit > 0.0:
            self._note_admissions()
        return pending

    def _finish_step(self, pending):
        """engine.step_finish() with its wall split into the device→host
        token sync and the readout/emit remainder."""
        eng, tel = self.engine, self.telemetry
        s_sync = eng.stats["host_sync_time_s"]
        s_emit = eng.stats["emit_time_s"]
        # speculative acceptance lands at readout, where the engine learns
        # which drafts committed
        s_spec = {k: eng.stats[k] for k in _SPEC_COUNTERS}
        t0 = time.perf_counter()
        done = eng.step_finish(pending)
        wall = time.perf_counter() - t0
        d_sync = eng.stats["host_sync_time_s"] - s_sync
        d_emit = eng.stats["emit_time_s"] - s_emit
        tel.add_stage("host_sync", d_sync)
        tel.add_stage("emit", d_emit)
        tel.add_stage("other", max(wall - d_sync - d_emit, 0.0))
        tel.inc("engine_steps")
        for key, before in s_spec.items():
            if eng.stats[key] > before:
                tel.inc(key, eng.stats[key] - before)
        return done

    def _admission_estimate_s(self):
        """Telemetry-estimated latency before a fresh submission's first
        token: mean queue wait + mean TTFT (0.0 on a cold server, so a
        cold start sheds nothing)."""
        tel = self.telemetry
        return tel.queue_wait_s.mean + tel.ttft_s.mean

    def _feed_engine(self):
        """Move queued requests into the engine's waiting deque, only as
        many as could plausibly admit (engine backlog <= max_batch), so
        queue wait is measured HERE and cancelling a queued request never
        digs through engine state."""
        eng, tel = self.engine, self.telemetry
        while len(eng.waiting) < eng.B:
            handle = self._queue.pop()
            if handle is None:
                return
            if handle.done:          # cancelled/expired while queued
                continue
            req = handle.request
            resume = list(req.resume_tokens or [])
            if self.shed_deadlines and req.deadline is not None:
                # admission-side shed: the remaining budget vs est. TTFT
                if req.deadline - time.monotonic() < tel.ttft_s.mean:
                    tel.inc("requests_shed_deadline")
                    self._finish_handle(handle, resume, "deadline")
                    continue
            self._readmit(handle, resume)

    def _update_gauges(self):
        """Sample the point-in-time engine state into the telemetry
        gauges, every loop pass."""
        eng, tel = self.engine, self.telemetry
        # the loop is provably passing right now: that IS healthy
        tel.set_gauge("server_healthy", 1.0)
        tel.set_gauge("queue_depth", len(self._queue))
        tel.set_gauge("engine_waiting", len(eng.waiting))
        tel.set_gauge("running_slots",
                      sum(1 for s in eng.slots if s is not None))
        tel.set_gauge("pipeline_inflight", eng._inflight)
        if eng.cache_impl == "paged":
            free = len(eng._free_blocks)
            tel.set_gauge("kv_pool_free_blocks", free)
            tel.set_gauge("kv_pool_occupancy",
                          1.0 - free / max(eng.n_blocks, 1))
            tel.set_gauge("kv_pool_effective_blocks",
                          eng.kv_pool_effective_blocks())
            # host KV tier traffic (0 with the tier off): the cumulative
            # swap bytes, and the spill store in blocks and in bytes, the
            # unit of its bound
            tel.set_gauge("kv_swap_in_bytes",
                          eng.stats.get("kv_swap_in_bytes", 0))
            tel.set_gauge("kv_swap_out_bytes",
                          eng.stats.get("kv_swap_out_bytes", 0))
            tel.set_gauge("kv_host_spill_blocks",
                          len(getattr(eng, "_spill", ())))
            tel.set_gauge("kv_host_spill_bytes",
                          getattr(eng, "_spill_bytes", 0))
            for key in ("kv_ship_out_blocks", "kv_ship_in_blocks",
                        "kv_ship_out_bytes", "kv_ship_in_bytes"):
                cur = eng.stats.get(key, 0)
                d = cur - self._ship_seen.get(key, 0)
                if d > 0:
                    tel.inc(key, d)
                    self._ship_seen[key] = cur
            if getattr(eng, "prefix_cache", False):
                tel.set_gauge("prefix_cached_blocks", len(eng._lru))
                hit = eng.stats["prefix_hit_tokens"]
                pre = eng.stats["prefill_tokens"]
                tel.set_gauge("prefix_cache_hit_rate",
                              hit / (hit + pre) if hit + pre else 0.0)
        prop = eng.stats.get("spec_proposed_tokens", 0)
        if prop:
            tel.set_gauge("spec_acceptance_rate",
                          eng.stats["spec_accepted_tokens"] / prop)
        rec = self.flight_recorder
        if rec is not None and rec.enabled:
            last = rec.last_record()
            if last is not None:
                tel.set_gauge("token_budget_utilization",
                              last.budget_utilization)
        tel.mark_gauge_sample()
        # the metrics store's off path is this one attribute check
        if self.metrics_store is not None:
            self._feed_sensors()

    def _feed_sensors(self):
        """Feed every gauge and cumulative counter into the metrics store
        as time series (counters stay cumulative: a windowed ``rate()``
        turns them into tokens/s, preemptions/s, ...), at most once per
        ``metrics_interval_s`` (reference ``server.py:1086-1106``, its
        SLO and black-box halves being ROADMAP A11)."""
        now = time.monotonic()
        if now - self._ms_last_t < self.metrics_interval_s:
            return
        self._ms_last_t = now
        store = self.metrics_store
        for name, v in self.telemetry.get_gauges().items():
            if name != "gauge_last_sample_age_s":
                # the staleness gauge is computed at read time: storing
                # the feed-time value would record the feed's own cadence
                store.observe(name, v, t=now)
        for name, v in self.telemetry.get_counters().items():
            store.observe(name, v, t=now)

    def dump_debug_bundle(self, path, reason="manual", detail=None):
        _a11("the black box (dump_debug_bundle)")

    def slo_report(self):
        _a11("the SLO layer (slo_report)")

    def _note_admissions(self):
        """Mark handles whose request just entered an engine slot RUNNING
        and record their queue wait (submit → slot admission) and
        admission stall (first free slot → slot admission)."""
        now = time.monotonic()
        with self._hlock:
            handles = dict(self._handles)
        for slot in self.engine.slots:
            if slot is None:
                continue
            h = handles.get(slot.req.request_id)
            if h is not None and h.state is RequestState.PENDING:
                h.state = RequestState.RUNNING
                h.admitted_at = now
                wait = now - h.request.submitted_at
                if self.flight_recorder is not None:
                    self.flight_recorder.req_event(
                        slot.req.request_id, "admitted")
                self.telemetry.inc("requests_admitted")
                self.telemetry.observe("queue_wait_s", wait,
                                       tenant=h.request.adapter_id)
                if self.metrics_store is not None:
                    self.metrics_store.observe(
                        "queue_wait_s", wait, t=now,
                        tenant=h.request.adapter_id)
                self.telemetry.observe(
                    "admission_stall_s",
                    max(now - h.stall_mark, 0.0)
                    if h.stall_mark is not None else 0.0)

    def _mark_admission_stalls(self):
        """Stamp the moment a FREE slot exists for a request that could
        take it; _note_admissions turns the stamp into the
        admission_stall_s observation. Only as many of the OLDEST pending
        requests as there are free slots carry a stamp, and a legacy
        paged engine (whole-prompt admission) or a fused one with a ramp
        in flight also needs the pool to cover the prompt: otherwise the
        request waits on capacity, not on admission."""
        eng = self.engine
        free = sum(1 for s in eng.slots if s is None)
        now = time.monotonic()
        with self._hlock:
            handles = list(self._handles.values())
        pending = sorted((h for h in handles
                          if h.state is RequestState.PENDING),
                         key=lambda h: h.request.submitted_at)
        paged = eng.cache_impl == "paged"
        legacy_paged = paged and eng.scheduler != "fused"
        fused_ramping = paged and not legacy_paged and any(
            s is not None and s.ramping for s in eng.slots)
        ramp_deficit = sum(
            max(eng.prefill_blocks_needed(s.prompt_len)
                - len(eng._slot_blocks[i]), 0)
            for i, s in enumerate(eng.slots)
            if s is not None and s.ramping) if fused_ramping else 0
        for i, h in enumerate(pending):
            admissible = i < free and (
                not (legacy_paged or fused_ramping)
                or eng.prefill_blocks_needed(len(h.request.prompt_ids))
                + ramp_deficit <= eng._n_allocatable())
            if admissible:
                if h.stall_mark is None:
                    h.stall_mark = now
            else:
                h.stall_mark = None

    def _sweep_cancels_and_deadlines(self):
        """Apply caller cancellations and expire deadlines. A running
        request's slot (and pool blocks) frees RIGHT HERE, before the
        next dispatch."""
        eng = self.engine
        now = time.monotonic()
        with self._hlock:
            items = list(self._handles.items())
        for rid, h in items:
            if h.done:
                continue
            expired = h.request.deadline is not None \
                and now > h.request.deadline
            if not h.cancel_requested and not expired:
                continue
            reason = "cancelled" if h.cancel_requested else "deadline"
            # a still-queued handle generated nothing HERE, but a failover
            # resume carries its previous replica's tokens
            tokens = list(h.request.resume_tokens or [])
            if h.state is RequestState.QUEUED:
                self._queue.remove(h)
            else:
                out = eng.cancel(rid, reason=reason)
                if out is not None:
                    eng.finished_outputs.pop(rid, None)
                    tokens = out.token_ids
            self.telemetry.inc("requests_expired" if reason == "deadline"
                               else "requests_cancelled")
            self._finish_handle(h, tokens, reason)

    def _on_token(self, rid, tok):
        """Engine stream callback (inside step_finish's readout): route
        the token to its handle and record TTFT / inter-token, the stamp
        backdated by the engine's ``emit_backdate_s`` and clamped
        monotonic per handle."""
        with self._hlock:
            h = self._handles.get(rid)
        if h is None:
            return
        now = time.monotonic() - self.engine.emit_backdate_s
        if h.last_token_at is not None and now < h.last_token_at:
            now = h.last_token_at
        tenant = h.request.adapter_id
        store = self.metrics_store
        if h.first_token_at is None:
            ttft = max(now - h.request.submitted_at, 0.0)
            self.telemetry.observe("ttft_s", ttft, tenant=tenant)
            if store is not None:
                store.observe("ttft_s", ttft, t=now, tenant=tenant)
        elif h.last_token_at is not None:
            gap = now - h.last_token_at
            self.telemetry.observe("inter_token_s", gap, tenant=tenant)
            if store is not None:
                store.observe("inter_token_s", gap, t=now, tenant=tenant)
        self.telemetry.inc("tokens_emitted")
        self.telemetry.inc_tenant(tenant)
        h._emit(tok, t=now)

    def _handle_done(self, outputs):
        for out in outputs:
            self.engine.finished_outputs.pop(out.request_id, None)
            with self._hlock:
                h = self._handles.get(out.request_id)
            if h is None:
                continue
            self._finish_handle(h, out.token_ids, out.finish_reason)

    def _finish_handle(self, handle, token_ids, reason):
        now = time.monotonic()
        req = handle.request
        trace = None
        rec = self.flight_recorder
        if rec is not None and rec.enabled:
            rec.req_event(handle.request_id, "finish", value=reason)
            trace = rec.request_trace(handle.request_id)
        result = ServeResult(
            handle.request_id, list(token_ids), reason, True,
            ttft_s=(handle.first_token_at - req.submitted_at
                    if handle.first_token_at is not None else None),
            e2e_s=now - req.submitted_at,
            queue_wait_s=(handle.admitted_at - req.submitted_at
                          if handle.admitted_at is not None else None),
            trace=trace, routing=req.routing, trace_ctx=req.trace_ctx)
        self.telemetry.inc("requests_finished")
        self.telemetry.observe("e2e_s", result.e2e_s, tenant=req.adapter_id)
        if self.metrics_store is not None:
            self.metrics_store.observe("e2e_s", result.e2e_s, t=now,
                                       tenant=req.adapter_id)
        with self._hlock:
            self._handles.pop(handle.request_id, None)
        handle._finish(result)
