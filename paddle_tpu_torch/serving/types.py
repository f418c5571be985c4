"""Request-lifecycle types for ``paddle_tpu_torch.serving`` (counterpart:
``paddle_tpu/serving/types.py``, ported verbatim).

Reference analog: the request objects PaddleNLP's serving stack threads
through AnalysisPredictor (SURVEY §1 layer 6c) — here shaped for an async
server: a submitted request is a handle the caller can STREAM from,
cancel, or await, while the engine thread owns every interaction with the
underlying :class:`~paddle_tpu_torch.inference.LLMEngine`.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import time
import uuid

import numpy as np

__all__ = ["RequestState", "ServeRequest", "ServeResult", "RequestHandle",
           "ServerQueueFull", "ServerClosed", "TraceContext",
           "TRACE_HOP_KINDS"]

#: every way a trace context may arrive at (or move between) serving
#: hops — the ``via`` vocabulary :meth:`TraceContext.child` accepts.
#: "submit"/"router" name the two mint sites; the rest name the hop
#: that RE-submitted the request somewhere else: a finished prefill
#: leg's KV ship, a replica-loss failover resubmission, a supervised
#: restart's re-admission, a queue-full park + retry.
TRACE_HOP_KINDS = ("submit", "router", "kv_ship", "failover", "restart",
                   "queue_retry")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's distributed trace identity — the Dapper-style
    (trace_id, hop) pair that survives every hop a request can take
    across the serving fleet (replica → KV ship → replica, failover
    resubmission, supervised-restart re-admission, queue-full retry),
    so ONE id names the request everywhere it ran.

    Immutable: a hop never mutates the context it received — it mints a
    :meth:`child` whose ``parent`` is the previous hop's span id, so
    the hop chain reconstructs from any single context. Minted at
    ``ReplicaRouter.submit`` (fleet entry) or ``AsyncLLMServer.submit``
    (single-server entry) when the caller didn't supply one."""

    trace_id: str                 # 16 hex chars, fleet-unique
    hop: int = 0                  # 0 at mint; +1 per resubmission hop
    parent: str | None = None     # previous hop's span_id (None at mint)
    via: str = "submit"           # TRACE_HOP_KINDS entry that made this hop

    @property
    def span_id(self):
        """This hop's span identity — ``trace_id/hop``."""
        return f"{self.trace_id}/{self.hop}"

    @classmethod
    def mint(cls, via="submit"):
        """A fresh root context (hop 0, no parent)."""
        if via not in TRACE_HOP_KINDS:
            raise ValueError(f"unknown trace hop kind {via!r}")
        return cls(trace_id=uuid.uuid4().hex[:16], via=via)

    def child(self, via):
        """The next hop's context: same trace_id, hop+1, parented on
        this hop's span id."""
        if via not in TRACE_HOP_KINDS:
            raise ValueError(f"unknown trace hop kind {via!r}")
        return TraceContext(self.trace_id, self.hop + 1, self.span_id,
                            via)

    def to_dict(self):
        return {"trace_id": self.trace_id, "hop": self.hop,
                "parent": self.parent, "via": self.via}

    @classmethod
    def coerce(cls, obj):
        """Normalize None / TraceContext / its dict form (the shape
        that rides JSON exports and recorder timelines) to a
        TraceContext or None."""
        if obj is None or isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            return cls(str(obj["trace_id"]), int(obj.get("hop", 0)),
                       obj.get("parent"), obj.get("via", "submit"))
        raise TypeError(f"cannot coerce {type(obj).__name__} to "
                        f"TraceContext")


class ServerQueueFull(RuntimeError):
    """Admission queue at capacity and the caller declined to wait —
    the server's backpressure signal."""


class ServerClosed(RuntimeError):
    """submit() after stop() (or on a never-started server)."""


class RequestState(enum.Enum):
    QUEUED = "queued"        # in the server admission queue
    PENDING = "pending"      # handed to the engine, waiting for a slot
    RUNNING = "running"      # admitted into an engine slot (prefilled)
    FINISHED = "finished"    # terminal: engine finish / cancel / deadline


@dataclasses.dataclass
class ServeRequest:
    """One submitted generation request (server-side record)."""
    request_id: int
    prompt_ids: np.ndarray
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int | None = None
    #: absolute time.monotonic() deadline; the engine thread cancels the
    #: request (freeing its slot / pool blocks) once this passes
    deadline: float | None = None
    submitted_at: float = 0.0
    #: opaque caller/router metadata (e.g. the ReplicaRouter's placement
    #: decision: replica index, policy, score, affinity tokens,
    #: routing_key). Surfaced verbatim on ServeResult.routing and
    #: stamped into the request's flight-recorder trace as a "routed"
    #: span, so per-request placement is observable in explain_tail.
    routing: dict | None = None
    #: tokens this request ALREADY streamed on a previous server/replica
    #: (failover resumption): admission prefills prompt⊕resume_tokens and
    #: the engine stitches them back in front of the continuation, so the
    #: terminal ServeResult carries the full stream while only NEW tokens
    #: stream out. They count against ``max_new_tokens`` (the ORIGINAL
    #: total budget — the engine generates the remainder).
    resume_tokens: list | None = None
    #: latency-tier pin for multi-step decode: cap the engine's
    #: ``readout_stride`` while this request is resident (1 = the host
    #: syncs every step, minimizing THIS request's inter-token latency
    #: at the batch's throughput cost). None = the engine default; inert
    #: on engines without multi-step decode.
    readout_stride: int | None = None
    #: the TENANT dimension (batched multi-LoRA): 0 = the base model,
    #: > 0 = a registered adapter id. Preserved across supervised
    #: restart re-admission and router failover resubmission, so a
    #: tenant's stream can never silently continue on the wrong weights.
    adapter_id: int = 0
    #: carried speculative acceptance EWMA (a failover's): seeds the
    #: engine's acceptance-adaptive verify windows for this request, so a
    #: low-acceptance stream does not restart at the full window. None =
    #: let the engine learn
    spec_ewma: float | None = None
    #: disaggregated serving: stage this request's committed KV as a
    #: shippable export entry at its finish (the router sets it on the
    #: PREFILL leg, so the decode replica imports instead of
    #: re-prefilling). Inert on a dense engine.
    export_kv: bool = False
    #: the request's distributed trace identity (minted at submit when
    #: absent) — preserved verbatim across restart re-admission and
    #: carried (hop-incremented) across ship/failover/retry
    #: resubmissions, so one trace_id names the request fleet-wide
    trace_ctx: TraceContext | None = None


@dataclasses.dataclass
class ServeResult:
    """Terminal outcome of a request, with its latency record."""
    request_id: int
    token_ids: list
    finish_reason: str | None
    finished: bool = True
    ttft_s: float | None = None
    e2e_s: float = 0.0
    queue_wait_s: float | None = None
    #: the request's flight-recorder span timeline (JSON-ready dict:
    #: queued → admitted → prefill chunks → per-token gaps → finish,
    #: every span stamped with the engine StepRecord id that produced
    #: it). None unless the server was started with a flight_recorder.
    trace: dict | None = None
    #: the routing/placement metadata the request was submitted with
    #: (see ServeRequest.routing) — how THIS request got where it ran
    routing: dict | None = None
    #: prefill-only (kind="embed") result: the mean-pooled final hidden
    #: state [hidden_size] (fp32 numpy), None for generation requests
    embedding: np.ndarray | None = None
    #: the trace context this (leg of the) request ran under — the
    #: terminal hop's identity; ``trace_ctx.trace_id`` joins the result
    #: back to every other hop's recorder timeline
    trace_ctx: TraceContext | None = None


class RequestHandle:
    """Caller-side view of one in-flight request.

    * **streaming**: iterate the handle (``for tok in handle``) to receive
      token ids as the engine decodes them; iteration ends at the
      terminal state (finish/cancel/deadline).
    * **await**: :meth:`result` blocks for the terminal
      :class:`ServeResult`.
    * **cancel**: :meth:`cancel` requests cancellation; the engine thread
      frees the slot (and paged pool blocks) at the next step boundary.

    Thread-safety: the engine thread produces (tokens, state
    transitions); any caller thread may consume. One condition variable
    serializes both."""

    def __init__(self, server, req: ServeRequest):
        self._server = server
        self.request = req
        self._cond = threading.Condition()
        self._tokens = collections.deque()
        #: EVERY token ever emitted to this handle, consumed or not — the
        #: supervised-restart / failover resume record: prompt⊕emitted is
        #: exactly the state a recovered engine must continue from
        self.emitted: list = []
        self.state = RequestState.QUEUED
        self.result_obj: ServeResult | None = None
        self.cancel_requested = False
        #: set by the engine thread at slot admission / first token
        self.admitted_at: float | None = None
        self.first_token_at: float | None = None
        self.last_token_at: float | None = None
        #: first moment a FREE slot existed while this request was still
        #: waiting — admission_stall_s measures admission lag from here
        self.stall_mark: float | None = None

    @property
    def request_id(self):
        return self.request.request_id

    @property
    def done(self):
        return self.state is RequestState.FINISHED

    def full_stream(self):
        """EVERYTHING this request ever streamed, across servers: the
        failover resume prefix (tokens from a previous replica) plus
        every token emitted here. THE definition the fault-tolerance
        layer builds results and restart re-admissions from — one copy,
        or eviction and recovery silently desynchronize."""
        return list(self.request.resume_tokens or []) + list(self.emitted)

    # -- engine-thread side ---------------------------------------------
    def _emit(self, tok, t=None):
        """``t``: an explicit monotonic stamp — the server passes the
        token's AMORTIZED device-step-boundary time under multi-step
        readout so latency stats see the stride's k tokens at k distinct
        times; clamped monotonic per handle."""
        with self._cond:
            self._tokens.append(tok)
            self.emitted.append(tok)
            now = time.monotonic() if t is None else t
            if self.last_token_at is not None and now < self.last_token_at:
                now = self.last_token_at
            if self.first_token_at is None:
                self.first_token_at = now
            self.last_token_at = now
            self._cond.notify_all()

    def _finish(self, result: ServeResult):
        with self._cond:
            self.result_obj = result
            self.state = RequestState.FINISHED
            self._cond.notify_all()

    # -- caller side ----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            while not self._tokens and not self.done:
                self._cond.wait()
            if self._tokens:
                return self._tokens.popleft()
            raise StopIteration

    def tokens(self, timeout=None):
        """Generator over the token stream with an optional PER-TOKEN
        timeout (None = wait forever; raises TimeoutError when the next
        token takes longer than ``timeout`` seconds)."""
        while True:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            with self._cond:
                while not self._tokens and not self.done:
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"request {self.request_id}: no token within "
                            f"{timeout}s")
                    self._cond.wait(remaining)
                if not self._tokens and self.done:
                    return
                tok = self._tokens.popleft()
            yield tok

    def result(self, timeout=None) -> ServeResult:
        """Block until the request reaches a terminal state."""
        with self._cond:
            if not self._cond.wait_for(lambda: self.done, timeout):
                raise TimeoutError(
                    f"request {self.request_id} not finished within "
                    f"{timeout}s")
            return self.result_obj

    def cancel(self):
        """Request cancellation. Idempotent; returns immediately — the
        terminal result (finish_reason 'cancelled', with any tokens
        already generated) arrives via result()/iteration."""
        self.cancel_requested = True
        self._server._wake()
