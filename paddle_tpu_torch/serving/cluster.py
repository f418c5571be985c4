"""The replica router (counterpart: ``paddle_tpu/serving/cluster.py``,
level 2).

N :class:`~paddle_tpu_torch.serving.AsyncLLMServer` replicas behind one
router that places every request by a score combining **load** (queue
depth + running slots + KV-pool occupancy, read from each replica's
telemetry gauges) and **prefix affinity** (a read-only probe of each
replica's content-hash store for the longest cached prefix of the
incoming prompt: the replica that already holds the system prompt serves
it with no prefill for the shared span). Placement falls back to
least-loaded when nothing hits. Failover: a dead or hung replica's QUEUED
requests (nothing streamed yet) resubmit transparently to survivors; its
IN-FLIGHT requests (tokens already streamed) fail with the attributable
``finish_reason="replica_lost"``, or with ``resume_inflight=True``
continue on a survivor from what the caller consumed.
:meth:`ReplicaRouter.drain` removes a replica gracefully (migrate queued,
finish running, stop).

Scoring formula (the reference's documented contract)::

    score(replica) = affinity_weight * hit_tokens / prompt_len
                   - load_weight * ((queue_depth + engine_waiting
                                     + running_slots) / max_batch
                                    + kv_pool_occupancy)

highest score wins; ties break toward the lower replica index.

Disaggregated prefill/decode (``roles={"prefill": [...], "decode":
[...]}``): a new prompt places on a prefill replica as a one-token leg
with ``export_kv`` staging; when the leg finishes the router ships the
staged KV over its ``transport``
(:class:`~paddle_tpu_torch.serving.kv_transport.InProcessTransport` by
default: real PTKV bytes) to a decode replica, which restores it and
recomputes one position, and the stream continues there under the same
rid. Any ship failure falls back to re-prefill on the decode side.
``pull_on_miss=True`` lets a replica whose prefix probe missed fetch the
cached span from the peer that holds it.

Replicas in one process on one card share its default stream: each
server's loop issues its steps on the current stream of its own thread,
which is the device's default stream, so one replica's readout also waits
for the other replica's queued work. The streams stay exact; the
replicas' step times couple.

Not in this port yet: level 1, the tensor-parallel engine
(``tp_serving_mesh``, ``shard_model_tp``, ``tp_engine``; ROADMAP A14);
adapter placement (A10: a nonzero ``adapter_id`` is forwarded and the
replicas reject it, so ``adapter_routed`` stays 0); :meth:`slo_report`
and :meth:`dump_debug_bundle` (A11), which raise.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

import numpy as np

from ..analysis import lock_watchdog as _lockwatch
from ..inference.llm_engine import _unported
from ..profiler.serving_telemetry import LatencyHistogram
from .kv_transport import MIGRATION_PHASES, InProcessTransport
from .types import (ServeResult, ServerClosed, ServerQueueFull,
                    TraceContext)

__all__ = ["ReplicaRouter", "RouterHandle", "FLEET_TAIL_CAUSES"]

#: every cause :meth:`ReplicaRouter.explain_tail` can name BEYOND the
#: per-replica :data:`~paddle_tpu_torch.profiler.flight_recorder
#: .TAIL_CAUSES` taxonomy: a cross-replica boundary gap is either the
#: migration itself (``kv_ship:{phase}``, phase the dominant entry of
#: ``kv_transport.MIGRATION_PHASES``) or a failover resubmission's
#: re-prefill window. STRICT registry, as the reference's.
FLEET_TAIL_CAUSES = ("failover_resubmit", "kv_ship:serialize",
                     "kv_ship:transport", "kv_ship:import",
                     "kv_ship:place", "kv_ship:stitch")


class RouterHandle:
    """Caller-side view of one routed request.

    Wraps the current replica-local
    :class:`~paddle_tpu_torch.serving.RequestHandle` and survives
    failover: a queued request whose replica dies is transparently
    re-attached to a survivor (``resubmits`` counts the hops); a request
    that had already streamed tokens finishes with
    ``finish_reason="replica_lost"`` (or continues, under
    ``resume_inflight``). Iterate for the token stream, :meth:`result` for
    the terminal :class:`~paddle_tpu_torch.serving.ServeResult` (its
    ``routing`` dict names the replica and the placement score that
    won)."""

    def __init__(self, router, prompt_ids, kwargs, routing_key=None):
        self._router = router
        self.prompt_ids = prompt_ids
        self._kwargs = kwargs
        self.routing_key = routing_key
        self._cond = threading.Condition()
        self._inner = None           # current replica-local RequestHandle
        self._replica = None
        self._final: ServeResult | None = None
        self._streamed = []          # tokens handed to the caller
        #: disaggregated serving state: {"budget": the original
        #: max_new_tokens, ...} on a request the router split into a
        #: prefill leg and a decode leg; None otherwise
        self._disagg = None
        #: tokens of a finished prefill leg the caller had NOT consumed
        #: when the ship migrated the stream: the decode replica takes them
        #: as its resume prefix and never re-emits them, so the router
        #: delivers them from here first
        self._carry = collections.deque()
        self._migrating = False      # drain: a cancel that must resubmit
        self.resubmits = 0
        #: failover-retry pacing: when every survivor's queue is full, a
        #: resubmission parks back in the outstanding set and retries on
        #: monitor ticks, with capped exponential backoff, until the
        #: router's retry window closes
        self._retry_since = None
        self._last_try = None
        self._retry_delay = router.poll_interval_s
        #: tokens the caller already consumed at failover time: the
        #: resume_inflight resubmission's continuation point
        self._resume_tokens = None

    @property
    def replica(self):
        """Index of the replica currently serving this request."""
        return self._replica

    @property
    def done(self):
        return self._final is not None

    @property
    def routing(self):
        """The routing/placement dict stamped on the current submission
        (also surfaced on the terminal ``ServeResult.routing``)."""
        inner = self._inner
        return inner.request.routing if inner is not None else None

    # -- router side -----------------------------------------------------
    def _attach(self, replica_idx, inner):
        with self._cond:
            self._inner = inner
            self._replica = replica_idx
            self._migrating = False
            self._cond.notify_all()

    def _finish(self, result):
        with self._cond:
            self._final = result
            self._cond.notify_all()

    # -- caller side -----------------------------------------------------
    def _pop_token(self):
        """Pop one streamed token AND record it in ``_streamed`` under
        the inner handle's lock: _resolve snapshots (pending deque,
        streamed list) under that lock too, so a crash result can never
        count a token in both. A migrated leg's carried tokens come
        first."""
        if self._carry:
            try:
                tok = self._carry.popleft()
            except IndexError:
                tok = None
            if tok is not None:
                self._streamed.append(tok)
                return tok
        inner = self._inner
        if inner is None:
            return None
        with inner._cond:
            if inner._tokens:
                tok = inner._tokens.popleft()
                self._streamed.append(tok)
                return tok
        return None

    def tokens(self, timeout=None):
        """Generator over the token stream (across failover re-attach),
        with an optional per-token timeout."""
        while True:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while True:
                tok = self._pop_token()
                if tok is not None:
                    break
                if self._final is not None:
                    # re-pop: a token emitted between the miss above and
                    # the final landing must still be delivered
                    tok = self._pop_token()
                    if tok is None:
                        return
                    break
                inner = self._inner
                if inner is not None and inner.done:
                    # nudge the router: the waiting client drives the
                    # resolve latency, the monitor is only the backstop
                    self._router._resolve(self)
                    with self._cond:
                        if self._final is None:
                            self._cond.wait(0.02)
                elif inner is not None:
                    # the streaming hot path waits on the INNER handle's
                    # condition, which _emit notifies (the bounded wait
                    # only notices a failover re-attach swapping _inner)
                    with inner._cond:
                        if not inner._tokens and not inner.done:
                            inner._cond.wait(0.05)
                else:
                    with self._cond:
                        if self._final is None:
                            self._cond.wait(0.02)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"routed request: no token within {timeout}s")
            yield tok

    def __iter__(self):
        return self.tokens()

    def result(self, timeout=None) -> ServeResult:
        """Block for the terminal result (post-failover if any)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                if self._final is not None:
                    return self._final
                inner = self._inner
            if inner is not None and inner.done:
                self._router._resolve(self)
                with self._cond:
                    # a parked failover retry leaves the handle as it was:
                    # wait as tokens() does (the reference re-polls at
                    # once, and that spin starves the survivor's serving
                    # thread of the interpreter lock)
                    if self._final is None and self._inner is inner:
                        self._cond.wait(0.02)
                continue
            if inner is not None:
                try:
                    inner.result(timeout=0.05)
                    continue   # inner done: the loop resolves it
                except TimeoutError:
                    pass
            else:
                with self._cond:
                    self._cond.wait(0.05)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"routed request not finished within {timeout}s")

    def cancel(self):
        inner = self._inner
        if inner is not None:
            inner.cancel()


class ReplicaRouter:
    """Load- and prefix-affinity-aware placement over N
    :class:`~paddle_tpu_torch.serving.AsyncLLMServer` replicas.

    ``policy``: ``"affinity"`` (the default: affinity score on top of
    least-loaded), ``"least_loaded"`` (ignore affinity), or ``"random"``
    (the bench's control arm; ``np.random.default_rng(seed)`` orders the
    candidates, so a seed places as the reference's does).
    ``submit(..., replica=i)`` pins a request explicitly (ops / tests).
    The router owns replica lifecycle when started through it:
    :meth:`start` starts un-started replicas plus the failover monitor,
    :meth:`stop` drains and stops everything.

    Failover contract: when a replica is LOST (its serving loop crashed
    terminally, or its :meth:`~AsyncLLMServer.health` probe reports
    ``"hung"``: heartbeat stale past ``step_timeout_s``, the thread may
    still be alive) every request it had QUEUED (nothing streamed yet) is
    resubmitted to a survivor and completes there (re-prefill reproduces
    the stream); every request already STREAMING fails with
    ``finish_reason="replica_lost"`` carrying the tokens streamed so far,
    or, with ``resume_inflight=True``, resubmits with ``resume_tokens``
    and CONTINUES on the survivor (token-exactly for greedy). A replica
    mid-supervised-restart (``"restarting"``) takes no new placements but
    keeps its residents: the resumption is about to happen locally.
    Nothing is silently dropped.

    ``roles``: disaggregated prefill/decode over those replica indices
    (module docstring); ``transport``: the KV mover (default: an
    :class:`~paddle_tpu_torch.serving.kv_transport.InProcessTransport`
    when ``roles`` or ``pull_on_miss`` is given); ``pull_on_miss``: fetch
    a missed prefix span from the peer that can serve it."""

    def __init__(self, replicas, affinity_weight=2.0, load_weight=1.0,
                 policy="affinity", poll_interval_s=0.01,
                 failover_retry_s=10.0, max_retry_backoff_s=0.5,
                 resume_inflight=False, seed=0,
                 adapter_affinity_weight=1.0, metrics_store=None,
                 metrics_interval_s=0.05, roles=None, transport=None,
                 pull_on_miss=False):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if policy not in ("affinity", "least_loaded", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.replicas = list(replicas)
        if roles is not None:
            n = len(self.replicas)
            roles = {k: sorted(int(i) for i in v)
                     for k, v in roles.items()}
            for k in ("prefill", "decode"):
                if not roles.get(k):
                    raise ValueError(f"roles needs a non-empty {k!r} "
                                     f"replica list")
                if any(i < 0 or i >= n for i in roles[k]):
                    raise ValueError(f"roles[{k!r}] has an out-of-range "
                                     f"replica index (have {n})")
            # a migrated request keeps its rid across replicas (the
            # restore validates by it): each replica gets a disjoint id
            # base, 2**26 apart so rids stay int32 for up to 31 replicas
            if n > 31:
                raise ValueError("disaggregated roles support at most "
                                 "31 replicas (int32 rid bases)")
            for i, srv in enumerate(self.replicas):
                srv._next_id = max(srv._next_id, i * (1 << 26))
        self.roles = roles
        #: the staged-entry mover: the in-process loopback (real PTKV
        #: bytes) unless one is given
        if transport is None and (roles is not None or pull_on_miss):
            transport = InProcessTransport()
        self.transport = transport
        self.pull_on_miss = bool(pull_on_miss)
        #: end-to-end migration latency (leg finish -> decode-side
        #: placement), observed per successful ship
        self.migration_latency = LatencyHistogram()
        #: the same latency per kv_transport.MIGRATION_PHASES name:
        #: serialize/transport/import timed inside the transport's ship(),
        #: place around the decode-side placement, stitch read back from
        #: the destination engine's restore
        self.migration_phases = {}
        #: per-migration records (trace_id, rid, src -> dst, perf_counter
        #: t0/t1, phase seconds, wire bytes), bounded: the merged trace's
        #: router lane and explain_tail's boundary-gap attribution
        self._migrations = collections.deque(maxlen=256)
        self.affinity_weight = float(affinity_weight)
        #: adapter-affinity bonus (multi-tenant serving): kept for the
        #: reference's signature; inert until A10 ports the adapter cache
        #: (the replicas reject a nonzero ``adapter_id``)
        self.adapter_affinity_weight = float(adapter_affinity_weight)
        self.load_weight = float(load_weight)
        self.policy = policy
        self.poll_interval_s = float(poll_interval_s)
        #: how long a failover resubmission keeps retrying when every
        #: survivor's queue is full before the request fails as
        #: replica_lost: transient backpressure must not drop requests.
        #: Retries pace with CAPPED EXPONENTIAL BACKOFF: the delay
        #: doubles from poll_interval_s up to max_retry_backoff_s
        self.failover_retry_s = float(failover_retry_s)
        self.max_retry_backoff_s = float(max_retry_backoff_s)
        #: upgrade the failover contract for IN-FLIGHT requests: resubmit
        #: them to a survivor with ``resume_tokens`` = everything the
        #: caller has consumed, so the stream CONTINUES, token-exactly for
        #: greedy requests. Opt-in: resumption recomputes the consumed
        #: prefix on the survivor
        self.resume_inflight = bool(resume_inflight)
        #: optional router-level metrics store: the monitor loop feeds
        #: its own view (outstanding placements per replica, failover
        #: counters) as replica-labeled series (True = default-sized)
        if metrics_store is True:
            from ..profiler.metrics_store import MetricsStore
            metrics_store = MetricsStore()
        self.metrics_store = metrics_store or None
        #: monitor-side feed throttle: the monitor ticks every
        #: poll_interval_s, the store samples at this cadence
        self.metrics_interval_s = float(metrics_interval_s)
        self._ms_last_t = 0.0
        self._rng = np.random.default_rng(seed)
        # PADDLE_TPU_LOCK_CHECKS=1: acquisition edges feed the lock-order
        # watchdog (paddle_tpu_torch.analysis.lock_watchdog)
        self._lock = _lockwatch.tracked(threading.Lock(),
                                        "ReplicaRouter._lock")
        self._outstanding: set[RouterHandle] = set()
        #: outstanding placements per replica, counted by the ROUTER at
        #: placement time: the load gauges are sampled by each replica's
        #: serve loop and lag a burst of submissions, so a salvo would
        #: otherwise pile onto whichever replica scored best a
        #: millisecond ago. The score uses max(gauges, this)
        self._live_per = [0] * len(self.replicas)
        self._draining: set[int] = set()
        self._stop_evt = threading.Event()
        self._monitor = None
        self.stats = {"submitted": 0, "affinity_routed": 0,
                      "adapter_routed": 0,
                      "resubmitted": 0, "replica_lost": 0,
                      "resumed": 0, "evicted_hung": 0,
                      #: failover resubmissions whose request was
                      #: SWAP-RESIDENT on the lost replica (its KV lived
                      #: in that host's RAM tier, awaiting re-admission):
                      #: every streamed token is already with the caller,
                      #: so resumption is exact and the host copy is
                      #: abandoned with the replica
                      "swap_resident_failover": 0,
                      #: disaggregated serving: prefill legs whose KV
                      #: shipped to a decode replica, legs that fell back to
                      #: re-prefill, host-resident KV abandoned by a lost
                      #: replica (swap-resident or mid-ship), and prefix
                      #: blocks fetched from peers on a probe miss
                      "kv_shipped": 0, "kv_ship_fallback": 0,
                      "kv_ship_abandoned": 0, "pull_on_miss_blocks": 0,
                      "placements": [0] * len(self.replicas)}

    # -- lifecycle -------------------------------------------------------
    def start(self):
        for srv in self.replicas:
            if srv._thread is None:
                srv.start()
        self._stop_evt.clear()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="paddle-tpu-router",
                                         daemon=True)
        self._monitor.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop the monitor and every replica. A replica whose stop fails
        (a crashed loop re-raising, or a TimeoutError from a join) is
        collected, not fatal, so one bad replica can't wedge cluster
        shutdown. Returns the ``[(replica_idx, exception), ...]`` list."""
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout)
            self._monitor = None
        errors = []
        for i, srv in enumerate(self.replicas):
            try:
                srv.stop(drain=drain, timeout=timeout)
            except Exception as e:   # noqa: BLE001 — collect, keep going
                errors.append((i, e))
        return errors

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False

    def alive(self, idx):
        srv = self.replicas[idx]
        return (srv._thread is not None and srv._thread.is_alive()
                and srv._crashed is None and srv._accepting)

    def healthy(self, idx):
        """Placement eligibility: thread-level liveness AND the health
        protocol's verdict. A ``"hung"`` replica takes no new placements
        and its residents fail over; a ``"restarting"`` one takes no new
        placements but its residents stay PUT."""
        if not self.alive(idx):
            return False
        try:
            return self.replicas[idx].health()["state"] == "running"
        except Exception:   # routing heuristic: never let it fail
            return True

    # -- placement -------------------------------------------------------
    def _score(self, idx, ids, hashes=None, adapter_id=0):
        """(score, affinity_tokens) of placing ``ids`` on replica
        ``idx``: the documented formula (module docstring). The
        reference's adapter-affinity bonus waits for A10. ``hashes``:
        precomputed chain hashes (they depend on token content + tenant
        only, so one computation serves every same-block_size
        replica)."""
        srv = self.replicas[idx]
        aff = 0
        if self.policy == "affinity":
            try:
                aff = int(srv.engine.probe_prefix_len(
                    ids, chain_hashes=hashes, adapter_id=adapter_id))
            except Exception:   # routing heuristic: never let it fail
                aff = 0
        g = srv.telemetry.get_gauges()
        load = (g.get("queue_depth", 0.0) + g.get("engine_waiting", 0.0)
                + g.get("running_slots", 0.0)) / max(srv.engine.B, 1)
        # the router's own outstanding count covers the gauge lag window;
        # max() rather than + because settled placements appear in both
        load = max(load, self._live_per[idx] / max(srv.engine.B, 1))
        # pool pressure counts only UNAVAILABLE blocks: LRU-cached
        # (evictable) prefix blocks would otherwise penalize exactly the
        # warm replica the affinity term prefers
        pool = g.get("kv_pool_occupancy", 0.0)
        cached = g.get("prefix_cached_blocks", 0.0)
        n_blocks = getattr(srv.engine, "n_blocks", 0)
        if n_blocks:
            pool = max(0.0, pool - cached / n_blocks)
        score = self.affinity_weight * (aff / max(len(ids), 1)) \
            - self.load_weight * (load + pool)
        return score, aff

    def _role_for(self, handle):
        """Which role set a submission places into, or None (no
        disaggregation): a split request's decode leg (its ship has begun)
        goes to decode replicas; everything else (fresh prompts, prefill
        legs retried after a lost replica) to prefill replicas."""
        if self.roles is None:
            return None
        d = handle._disagg
        return "decode" if (d is not None and d.get("shipping")) \
            else "prefill"

    def _rank(self, ids, pin=None, adapter_id=0, role=None):
        """Candidate replicas best-first as (idx, score, aff_tokens).
        ``role``: only that role set's replicas, or every healthy replica
        when the whole set is down (losing the last prefill replica turns
        prompts into mixed placement instead of lost requests)."""
        #: prompt hash chain per (block_size, tenant): computed at most
        #: once per submission, shared by same-geometry replicas' probes
        hash_cache = {}

        def hashes_for(idx):
            eng = self.replicas[idx].engine
            if self.policy != "affinity" or \
                    getattr(eng, "prefix_cache", False) is False:
                return None
            key = (eng.block_size, adapter_id)
            if key not in hash_cache:
                hash_cache[key] = eng.prefix_chain_hashes(
                    ids, adapter_id=adapter_id)
            return hash_cache[key]

        if pin is not None:
            return [(pin,) + self._score(pin, ids, hashes_for(pin),
                                         adapter_id)]
        cand = [i for i in range(len(self.replicas))
                if self.healthy(i) and i not in self._draining]
        if role is not None and self.roles is not None:
            cand = [i for i in cand if i in self.roles[role]] or cand
        if not cand:
            return []
        if self.policy == "random":
            order = [int(i) for i in self._rng.permutation(cand)]
            return [(i, 0.0, 0) for i in order]
        scored = [(i,) + self._score(i, ids, hashes_for(i), adapter_id)
                  for i in cand]
        scored.sort(key=lambda t: (-t[1], t[0]))
        return scored

    # -- submission ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=64, temperature=0.0,
               top_p=1.0, eos_token_id=None, deadline_s=None,
               routing_key=None, replica=None, block=True,
               timeout=None, readout_stride=None, adapter_id=0,
               kind="generate") -> RouterHandle:
        """Place and submit one request; returns its
        :class:`RouterHandle`. ``routing_key`` is an opaque caller tag
        that rides the placement dict into ``ServeResult.routing`` and
        the request's trace spans. ``replica`` pins placement (skips
        scoring). ``readout_stride`` is the per-request latency-tier pin,
        forwarded to whichever replica serves (and re-serves) the
        request. Backpressure: a replica whose queue is full is skipped
        for the next-best; with every queue full, blocks (``block=True``,
        up to ``timeout``) or raises
        :class:`~paddle_tpu_torch.serving.ServerQueueFull`."""
        ids = np.asarray(
            prompt_ids.numpy() if hasattr(prompt_ids, "numpy")
            else prompt_ids, dtype=np.int32).reshape(-1)
        kwargs = dict(max_new_tokens=max_new_tokens,
                      temperature=temperature, top_p=top_p,
                      eos_token_id=eos_token_id, deadline_s=deadline_s,
                      readout_stride=readout_stride,
                      adapter_id=adapter_id, kind=kind,
                      # fleet-entry trace mint: rides _kwargs so EVERY
                      # resubmission hop carries the same trace_id; the
                      # hop-bump sites replace it with child contexts
                      trace_ctx=TraceContext.mint("router"))
        handle = RouterHandle(self, ids, kwargs, routing_key)
        if self.roles is not None and kind == "generate" and \
                int(max_new_tokens) > 1:
            # the disaggregated split: a ONE-token prefill leg with export
            # staging; its finish ships the KV and resubmits the rest of
            # the budget on a decode replica (a budget of 1 is all prefill)
            handle._disagg = {"budget": int(max_new_tokens)}
            kwargs["max_new_tokens"] = 1
            kwargs["export_kv"] = True
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = self.poll_interval_s
        while True:
            err = self._try_place(handle, ids, pin=replica)
            if err is None:
                return handle
            # a validation rejection is the caller's bug, not transient
            # backpressure: surface it synchronously, never retry it
            if not block or isinstance(err, (ServerClosed, ValueError)):
                raise err
            if deadline is not None and time.monotonic() > deadline:
                raise err
            # capped exponential backoff
            time.sleep(delay)
            delay = min(delay * 2.0, self.max_retry_backoff_s)

    def _try_place(self, handle, ids, pin=None, resubmit=False):
        """One placement pass over the ranked candidates. Returns None
        on success, else the error to surface (queue-full everywhere /
        no replica alive). Scoring runs OUTSIDE the router lock (scores
        are an advisory heuristic over point-in-time reads); the lock
        guards only the placement bookkeeping."""
        adapter_id = int(handle._kwargs.get("adapter_id") or 0)
        ranked = self._rank(ids, pin=pin, adapter_id=adapter_id,
                            role=self._role_for(handle))
        if self.pull_on_miss and ranked and \
                handle._kwargs.get("kind", "generate") == "generate":
            # BEFORE the submit: the fetched span must be in the target's
            # spill inbox before its engine thread admits this request
            self._pull_prefix(ranked[0], ids, adapter_id)
        with self._lock:
            last_err = None
            for idx, score, aff in ranked:
                srv = self.replicas[idx]
                routing = {"replica": idx, "policy": self.policy,
                           "score": round(float(score), 4),
                           "affinity_tokens": int(aff),
                           # the handle's counter increments only once
                           # this placement SUCCEEDS: stamp what this
                           # submission will be
                           "resubmits": handle.resubmits
                           + (1 if resubmit else 0)}
                if adapter_id:
                    routing["adapter_id"] = adapter_id
                if handle.routing_key is not None:
                    routing["routing_key"] = handle.routing_key
                try:
                    inner = srv.submit(ids, routing=routing, block=False,
                                       resume_tokens=handle._resume_tokens
                                       or None, **handle._kwargs)
                except (ServerQueueFull, ServerClosed, ValueError) as e:
                    # ValueError: this replica's validation rejected the
                    # prompt; a differently-sized survivor may still take
                    # it, and an uncaught raise here would kill the
                    # monitor thread mid-failover
                    last_err = e
                    continue
                handle._attach(idx, inner)
                self._outstanding.add(handle)
                self._live_per[idx] += 1
                self.stats["placements"][idx] += 1
                if not resubmit:
                    self.stats["submitted"] += 1
                    if aff > 0:
                        self.stats["affinity_routed"] += 1
                return None
            return last_err or ServerClosed("no replica alive")

    def _pull_prefix(self, top, ids, adapter_id):
        """Pull-on-miss: when the chosen replica's prefix probe (device
        store and its own spill store) covers less of this prompt than a
        peer could serve, fetch the missing span's blocks from that peer
        over the transport instead of recomputing them. Best-effort and
        read-only on the peer; the target re-derives every chain hash
        before registering. Needs the target's spill store armed
        (``kv_host_spill_bytes > 0``): the blocks land there and its probe
        promotes them."""
        idx, _, aff = top
        eng = self.replicas[idx].engine
        if self.transport is None or \
                not getattr(eng, "prefix_cache", False) or \
                not getattr(eng, "kv_host_spill_bytes", 0):
            return
        bs = eng.block_size
        try:
            hashes = eng.prefix_chain_hashes(ids, adapter_id=adapter_id)
        except Exception:
            return
        have = int(aff) // bs
        if have >= len(hashes):
            return
        want = hashes[have:]
        best_peer, best_len = None, 0
        for j, srv in enumerate(self.replicas):
            if j == idx or not self.healthy(j):
                continue
            peng = srv.engine
            if getattr(peng, "block_size", None) != bs or \
                    getattr(peng, "kv_quant", None) != eng.kv_quant:
                continue
            try:
                plen = int(peng.probe_prefix_len(
                    ids, chain_hashes=hashes, adapter_id=adapter_id))
            except Exception:
                continue
            if plen // bs > have and plen > best_len:
                best_peer, best_len = peng, plen
        if best_peer is None:
            return
        try:
            entries = best_peer.export_prefix_blocks(want)
            if not entries:
                return
            n, _ = self.transport.ship_prefix_blocks(entries, eng)
        except Exception:
            return
        if n:
            with self._lock:
                self.stats["pull_on_miss_blocks"] += n

    def num_outstanding(self):
        with self._lock:
            return len(self._outstanding)

    # -- failover / resolution -------------------------------------------
    def _bump_trace(self, handle, via):
        """Advance the handle's trace context one hop: same trace_id,
        hop+1, parented on the previous hop's span. Called once per
        resubmission EPISODE (ship, failover, first queue-full park), never
        per retry tick."""
        tc = TraceContext.coerce(handle._kwargs.get("trace_ctx"))
        if tc is not None:
            handle._kwargs["trace_ctx"] = tc.child(via)

    def _done_with(self, handle):
        """Drop a handle from the outstanding set + the per-replica
        placement count (CALLER HOLDS self._lock)."""
        if handle in self._outstanding:
            self._outstanding.discard(handle)
            if handle._replica is not None:
                self._live_per[handle._replica] -= 1

    def _monitor_loop(self):
        while not self._stop_evt.wait(self.poll_interval_s):
            with self._lock:
                handles = list(self._outstanding)
            for rh in handles:
                inner = rh._inner
                if inner is not None and inner.done:
                    self._resolve(rh)
            self._failover_hung()
            if self.metrics_store is not None:
                self._feed_metrics_store()

    def _feed_metrics_store(self):
        """Feed the router's own counters + per-replica placement view
        into the router-level metrics store (interval-throttled)."""
        store = self.metrics_store
        t = time.monotonic()
        if t - self._ms_last_t < self.metrics_interval_s:
            return
        self._ms_last_t = t
        with self._lock:
            live = list(self._live_per)
            stats = dict(self.stats)
        store.observe("router_outstanding", sum(live), t=t)
        for i, n in enumerate(live):
            store.observe("router_replica_outstanding", n, t=t,
                          replica=i)
        for key in ("submitted", "resubmitted", "replica_lost",
                    "resumed", "evicted_hung"):
            store.observe(f"router_{key}", stats[key], t=t)

    def _failover_hung(self):
        """Health-probe failover: a replica whose :meth:`AsyncLLMServer
        .health` verdict is ``"hung"`` gets its resident requests evicted
        and failed over NOW, without waiting for the thread to die.
        ``evict_request`` detaches each handle from the wedged server (a
        later revival decodes into dropped outputs, never into a double
        delivery), and the normal resolve path converts the eviction
        into resubmission; with ``resume_inflight``, stream
        continuation."""
        for idx, srv in enumerate(self.replicas):
            try:
                hung = srv.health()["state"] == "hung"
            except Exception:
                hung = False
            if not hung:
                continue
            # swap-resident awareness: requests whose KV the wedged
            # replica had demoted to ITS host tier are in no slot, but
            # they are exactly as resumable as running ones. The probe is
            # a read of the (stuck, not racing) engine thread's dict
            try:
                swap_rids = set(srv.engine.swap_resident_rids())
            except Exception:
                swap_rids = set()
            with self._lock:
                mine = [rh for rh in self._outstanding
                        if rh._replica == idx and not rh.done]
            for rh in mine:
                inner = rh._inner
                if inner is not None and not inner.done:
                    if srv.evict_request(inner.request_id,
                                         reason="replica_lost") is not None:
                        with self._lock:
                            self.stats["evicted_hung"] += 1
                            if inner.request_id in swap_rids:
                                self.stats["swap_resident_failover"] += 1
                                # the wedged replica's host-resident KV
                                # copy is abandoned with it
                                self.stats["kv_ship_abandoned"] += 1
                self._resolve(rh)

    def _resolve(self, handle):
        """Turn a finished replica-local result into the routed request's
        fate: final result, or failover resubmission. Idempotent AND
        race-safe: membership in the outstanding set (removed atomically
        under the router lock) is the gate, so exactly one caller acts."""
        inner = handle._inner
        if inner is None or not inner.done or handle.done:
            return
        res = inner.result_obj
        reason = res.finish_reason or ""
        #: "lost" covers both shapes of replica loss: a terminal serve-
        #: loop crash (server_error) and a hung-replica eviction
        #: (replica_lost via evict_request)
        lost = reason.startswith("server_error") or \
            reason == "replica_lost"
        migrating = handle._migrating and reason == "cancelled"
        streamed = inner.first_token_at is not None
        d = handle._disagg
        if d is not None and not lost and not migrating and \
                reason == "length" and not d.get("placed"):
            # the PREFILL-COMPLETE hook: the leg spent its one-token budget
            # with the real budget left: ship the staged KV and continue
            # on a decode replica
            self._ship_and_resubmit(handle, inner, res)
            return
        if d is not None and lost and not d.get("placed") and \
                not d.get("abandoned"):
            # the prefill leg's replica died with the staged KV on it: the
            # transfer work is lost; the plain failover path re-prefills
            d["abandoned"] = True
            with self._lock:
                self.stats["kv_ship_abandoned"] += 1
        # in-flight resumption (opt-in): resubmit with resume_tokens =
        # everything the caller consumed
        resume_stream = lost and streamed and self.resume_inflight
        # a drain-migration that raced its cancel against the first token
        # must NOT resubmit (the caller may already hold tokens a fresh
        # greedy stream would repeat): the cancel stands
        resubmit = (lost and not streamed) or resume_stream or \
            (migrating and not streamed and not handle._streamed)
        now = time.monotonic()
        if resubmit and handle._last_try is not None and \
                now - handle._last_try < handle._retry_delay:
            # pacing: a queue-full retry parked the handle; wait out its
            # current backoff delay
            return
        with self._lock:
            if handle not in self._outstanding:
                return          # another caller won the resolve
            self._done_with(handle)
            if resubmit:
                handle._replica = None   # no live placement while parked
            if lost and streamed and not resume_stream:
                self.stats["replica_lost"] += 1
        if not lost and not migrating:
            handle._finish(res)
            return
        if not resubmit:
            if lost:
                # in-flight: tokens already left the building; fail
                # attributably with everything streamed so far (snapshot
                # under the lock _pop_token records with)
                with inner._cond:
                    pending = list(inner._tokens)
                    emitted = list(handle._streamed)
                handle._finish(ServeResult(
                    res.request_id, emitted + pending,
                    "replica_lost", True, routing=inner.request.routing,
                    trace_ctx=res.trace_ctx or inner.request.trace_ctx))
            else:
                handle._finish(res)
            return
        if resume_stream:
            # freeze the dead stream: clear the undelivered deque under
            # the pop lock, then resume from exactly what the caller HAS
            # seen
            with inner._cond:
                inner._tokens.clear()
                handle._resume_tokens = list(handle._streamed)
        # carry the dead replica's draft-acceptance EWMA to the survivor
        # (speculative engines), as the readout_stride pin rides _kwargs
        try:
            ewma = inner._server.engine.spec_ewma_for(inner.request_id)
        except Exception:
            ewma = None
        if ewma is not None:
            handle._kwargs["spec_ewma"] = ewma
        if handle._retry_since is None:
            # first attempt of this failover episode: parked queue-full
            # retries keep the already-bumped context
            self._bump_trace(handle, "failover")
        handle._last_try = now
        err = self._try_place(handle, handle.prompt_ids, resubmit=True)
        if err is None:
            handle.resubmits += 1
            handle._retry_since = None
            handle._retry_delay = self.poll_interval_s
            with self._lock:
                self.stats["resubmitted"] += 1
                if resume_stream:
                    self.stats["resumed"] += 1
            return
        if isinstance(err, ServerQueueFull) and not self._stop_evt.is_set():
            # transient backpressure on the survivors: park the handle
            # back in the outstanding set; the monitor's next tick
            # retries, the delay doubling up to max_retry_backoff_s,
            # until the failover window closes
            if handle._retry_since is None:
                handle._retry_since = now
                self._bump_trace(handle, "queue_retry")
            if now - handle._retry_since < self.failover_retry_s:
                handle._retry_delay = min(handle._retry_delay * 2.0,
                                          self.max_retry_backoff_s)
                with self._lock:
                    self._outstanding.add(handle)
                return
        with self._lock:
            self.stats["replica_lost"] += 1
        handle._finish(ServeResult(
            res.request_id,
            # a lost replica's terminal result already carries the full
            # emitted stream (resume prefix included); a failed drain
            # migration only ever handed out what the caller consumed
            list(res.token_ids) if lost else list(handle._streamed),
            "replica_lost", True, routing=inner.request.routing,
            trace_ctx=res.trace_ctx or inner.request.trace_ctx))

    def _ship_and_resubmit(self, handle, inner, res):
        """The prefill-complete hook (disaggregated serving): export the
        finished leg's staged KV, ship it over the transport to the best
        decode replica, and resubmit the rest of the budget there under the
        SAME rid with the leg's tokens as resume prefix: the decode
        engine's restore re-admits with the one-token stitch (a
        front-of-queue grant, like a failover resume), so the migrated
        request re-prefills nothing. ANY failure (the export was dropped,
        a transport or geometry reject, a full queue on the shipped-to
        replica) falls back to plain resume resubmission (re-prefill on
        the decode side, the same stream). Re-entrant: a queue-full park
        retries from the monitor with the staged entry kept on the handle,
        paced by the failover backoff."""
        now = time.monotonic()
        if handle._last_try is not None and \
                now - handle._last_try < handle._retry_delay:
            return                   # parked: wait out the backoff
        with self._lock:
            if handle not in self._outstanding:
                return               # another caller won the resolve
            self._done_with(handle)
            handle._replica = None
        t0 = time.perf_counter()
        d = handle._disagg
        if not d.get("shipping"):
            # the first ship attempt of this migration: the decode leg is
            # hop + 1 (parked retries keep the bumped context)
            self._bump_trace(handle, "kv_ship")
        d["shipping"] = True         # the role flips to "decode" here
        src = inner._server
        src_idx = next((i for i, s in enumerate(self.replicas)
                        if s is src), None)
        rid = inner.request_id
        # freeze the leg's stream: undelivered tokens move to the carry
        # (the decode replica takes the whole leg stream as its resume
        # prefix and never re-emits it)
        with inner._cond:
            pending = list(inner._tokens)
            inner._tokens.clear()
        handle._carry.extend(pending)
        leg_tokens = [int(t) for t in res.token_ids]
        handle._resume_tokens = leg_tokens
        handle._kwargs["max_new_tokens"] = d["budget"]
        handle._kwargs["export_kv"] = False
        # the rid is the migration's identity: the decode engine's
        # restore validates by it
        handle._kwargs["request_id"] = rid
        if "entry" not in d:
            try:
                te0 = time.perf_counter()
                d["entry"] = src.engine.export_kv(rid)
                # the source-side export (waiting for the staged copy) is
                # part of the serialize phase
                d["export_s"] = time.perf_counter() - te0
            except Exception:
                d["entry"] = None
        entry = d["entry"]
        full_ids = np.concatenate(
            [np.asarray(handle.prompt_ids, np.int32),
             np.asarray(leg_tokens, np.int32)])
        adapter_id = int(handle._kwargs.get("adapter_id") or 0)
        ranked = self._rank(full_ids, adapter_id=adapter_id, role="decode")
        shipped = False
        err = ServerClosed("no replica alive")
        phases, nbytes, dst_idx = {}, 0, None
        for idx, _score, _aff in ranked:
            dst = self.replicas[idx]
            shipped = False
            phases, nbytes, dst_idx = {}, 0, idx
            if entry is not None and self.transport is not None:
                try:
                    # the transport times its own phases and returns them
                    # per call, so concurrent ships cannot clobber them
                    nbytes, tphases = self.transport.ship(entry, dst.engine)
                    shipped = True
                    phases = dict(tphases or {})
                    if "serialize" in phases:
                        phases["serialize"] += d.get("export_s", 0.0)
                except Exception:
                    shipped = False
            tp0 = time.perf_counter()
            err = self._try_place(handle, handle.prompt_ids, pin=idx,
                                  resubmit=True)
            if err is None:
                if shipped:
                    phases["place"] = time.perf_counter() - tp0
                break
            if shipped:
                # the placement failed after the import landed: pop the
                # orphaned entry so it cannot linger under a rid this
                # replica never admits
                try:
                    dst.engine._swap_store.pop(rid, None)
                except Exception:
                    pass
                shipped = False
        if err is None:
            d["placed"] = True
            handle.resubmits += 1
            handle._retry_since = None
            handle._retry_delay = self.poll_interval_s
            handle._last_try = None
            t1 = time.perf_counter()
            self.migration_latency.observe(t1 - t0)
            if shipped:
                for p, v in phases.items():
                    self._observe_phase(p, v)
                tc = TraceContext.coerce(handle._kwargs.get("trace_ctx"))
                with self._lock:
                    # stitch is timed on the destination (its restore, after
                    # this returns): _finalize_migrations reads it back
                    self._migrations.append({
                        "trace_id": tc.trace_id if tc else None,
                        "rid": rid, "src": src_idx, "dst": dst_idx,
                        "t0": t0, "t1": t1, "phases": phases,
                        "bytes": int(nbytes)})
            with self._lock:
                self.stats["resubmitted"] += 1
                if shipped:
                    self.stats["kv_shipped"] += 1
                else:
                    self.stats["kv_ship_fallback"] += 1
            return
        if isinstance(err, ServerQueueFull) and \
                not self._stop_evt.is_set():
            # transient decode-side backpressure: park and retry from the
            # monitor, exactly like a failover resubmission
            if handle._retry_since is None:
                handle._retry_since = now
                self._bump_trace(handle, "queue_retry")
            if now - handle._retry_since < self.failover_retry_s:
                handle._last_try = now
                handle._retry_delay = min(handle._retry_delay * 2.0,
                                          self.max_retry_backoff_s)
                with self._lock:
                    self._outstanding.add(handle)
                return
        # terminal: the retry window closed or no replica can take it
        with self._lock:
            self.stats["replica_lost"] += 1
            self.stats["kv_ship_fallback"] += 1
        handle._finish(ServeResult(
            res.request_id, list(res.token_ids), "replica_lost", True,
            routing=inner.request.routing,
            trace_ctx=res.trace_ctx or inner.request.trace_ctx))

    # -- migration phase bookkeeping -------------------------------------
    def _observe_phase(self, phase, seconds):
        """Book one migration phase observation (a histogram a
        MIGRATION_PHASES name, made at first use)."""
        h = self.migration_phases.get(phase)
        if h is None:
            h = self.migration_phases[phase] = LatencyHistogram()
        h.observe(seconds)

    def _finalize_migrations(self):
        """Fill in each migration record's ``stitch`` wall (timed by the
        decode engine's restore after the ship returned, so read back
        here) and book it once into the phase histograms. Returns the
        records, oldest first."""
        with self._lock:
            migs = list(self._migrations)
        for m in migs:
            if "stitch" not in m["phases"] and m["dst"] is not None:
                eng = self.replicas[m["dst"]].engine
                s = getattr(eng, "_stitch_s", {}).get(m["rid"])
                if s is not None:
                    m["phases"]["stitch"] = s
                    self._observe_phase("stitch", s)
        return migs

    # -- drain -----------------------------------------------------------
    def drain(self, idx, timeout=30.0):
        """Gracefully remove replica ``idx``: stop placing new work on
        it, migrate its queued (nothing-streamed) requests to survivors,
        let its running requests finish, then stop it. The replica stays
        in ``replicas`` (stopped) so indices remain stable."""
        with self._lock:
            self._draining.add(idx)
            srv = self.replicas[idx]
            mine = [rh for rh in self._outstanding
                    if rh._replica == idx and not rh.done]
        for rh in mine:
            inner = rh._inner
            if inner is not None and inner.first_token_at is None:
                rh._migrating = True
                inner.cancel()
        deadline = time.monotonic() + timeout
        while any(rh._migrating and not rh.done for rh in mine):
            if time.monotonic() > deadline:
                raise TimeoutError(f"drain({idx}): migrations incomplete "
                                   f"after {timeout}s")
            for rh in mine:
                inner = rh._inner
                if rh._migrating and inner is not None and inner.done:
                    self._resolve(rh)
            time.sleep(self.poll_interval_s)
        srv.stop(drain=True, timeout=max(deadline - time.monotonic(), 0.1))

    # -- observability ---------------------------------------------------
    def snapshot(self):
        """JSON-ready cluster view: router stats, roles, the migration
        latency and its phases, the transport's counters, and each
        replica's telemetry snapshot (keyed by replica index), with the
        reference's keys."""
        with self._lock:
            out = {"policy": self.policy,
                   "stats": {k: (list(v) if isinstance(v, list) else v)
                             for k, v in self.stats.items()},
                   "draining": sorted(self._draining)}
        if self.roles is not None:
            out["roles"] = {k: list(v) for k, v in self.roles.items()}
        migs = self._finalize_migrations()
        out["migration_latency"] = self.migration_latency.snapshot()
        out["migration_phases"] = {
            p: h.snapshot()
            for p, h in sorted(self.migration_phases.items())}
        out["migrations_recorded"] = len(migs)
        if self.transport is not None:
            out["transport"] = {
                "ship_count": getattr(self.transport, "ship_count", 0),
                "ship_bytes": getattr(self.transport, "ship_bytes", 0),
                "fail_count": getattr(self.transport, "fail_count", 0)}
        out["replicas"] = {}
        for i, srv in enumerate(self.replicas):
            eng = srv.engine
            try:
                swap_resident = len(eng.swap_resident_rids())
            except Exception:
                swap_resident = 0
            out["replicas"][i] = {
                "alive": self.alive(i),
                "tp_degree": eng.tp_degree(),
                # host KV tier view: requests parked in this replica's
                # host RAM and its spill store's size (in the unit of its
                # byte bound too)
                "kv_tier": {
                    "swap_resident": swap_resident,
                    "spill_blocks": len(getattr(eng, "_spill", ())),
                    "spill_bytes": getattr(eng, "_spill_bytes", 0),
                    "swap_out_bytes": eng.stats.get("kv_swap_out_bytes",
                                                    0),
                    "swap_in_bytes": eng.stats.get("kv_swap_in_bytes", 0),
                    "ship_out_bytes": eng.stats.get("kv_ship_out_bytes",
                                                    0),
                    "ship_in_bytes": eng.stats.get("kv_ship_in_bytes", 0),
                },
                "telemetry": srv.telemetry.snapshot()}
        return out

    def slo_report(self):
        """The fleet-level SLO/sensor report is not ported yet (A11)."""
        _unported("the fleet SLO report (slo_report)", "A11")

    def prometheus_text(self):
        """One VALID Prometheus exposition across replicas: same-name
        series merge into one metric family (a single ``# TYPE`` line,
        then every replica's labeled samples); naive concatenation would
        repeat TYPE lines per replica, which strict parsers reject. Each
        replica's telemetry must carry its own ``replica`` label
        (``AsyncLLMServer(replica=i)``) or the merged samples collide."""
        families = {}            # metric name -> (type_line, [samples])
        order = []
        for srv in self.replicas:
            current = None
            for line in srv.telemetry.prometheus_text().splitlines():
                if line.startswith("# TYPE "):
                    name = line.split()[2]
                    if name not in families:
                        families[name] = (line, [])
                        order.append(name)
                    current = name
                elif line:
                    families[current][1].append(line)
        out = []
        for name in order:
            type_line, samples = families[name]
            out.append(type_line)
            out.extend(samples)
        return "\n".join(out) + "\n"

    def export_merged_trace(self, path):
        """Merge every recorder-equipped replica's chrome trace into one
        Perfetto-loadable timeline, one process lane group per replica
        (:func:`paddle_tpu_torch.profiler.merge_profile`), then STITCH it:
        every request whose spans landed on more than one (pid, tid) lane
        (a shipped decode leg, a failover resubmission) gets Perfetto FLOW
        events (``"ph":"s"`` → ``"ph":"f"``, matched on name+cat+id under
        :data:`~paddle_tpu_torch.profiler.flight_recorder
        .FLOW_EVENT_NAME`) chaining its lanes in time order; each recorded
        migration renders its router-side phase spans
        (``kv_ship:serialize/transport/import/place``) on a
        ``router:migrations`` process lane (the destination's
        ``kv_stitch`` span completes it on the decode replica's lane). All
        replicas share this process's perf_counter clock, so no alignment
        is applied."""
        import tempfile

        from ..profiler import merge_profile
        from ..profiler.flight_recorder import FLOW_EVENT_NAME

        with tempfile.TemporaryDirectory(
                prefix="paddle_tpu_cluster_trace_") as tmpd:
            files = []
            for i, srv in enumerate(self.replicas):
                rec = srv.flight_recorder
                if rec is None:
                    continue
                files.append(rec.export_chrome_trace(
                    os.path.join(tmpd, f"replica{i}.json")))
            if not files:
                raise RuntimeError(
                    "no replica has a flight recorder attached "
                    "(AsyncLLMServer(flight_recorder=True))")
            # same process, same perf_counter clock: keep it (aligning
            # would destroy cross-replica simultaneity)
            merge_profile(files, path, align_start=False)
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"]
        lanes = {}       # trace_id -> {(pid, tid): (min_ts, max_end)}
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") != "request":
                continue
            trace_id = (ev.get("args") or {}).get("trace_id")
            if trace_id is None:
                continue
            key = (ev["pid"], ev["tid"])
            lane = lanes.setdefault(trace_id, {})
            lo, hi = lane.get(key, (float("inf"), float("-inf")))
            lane[key] = (min(lo, ev["ts"]),
                         max(hi, ev["ts"] + ev.get("dur", 0.0)))
        flow_id = 0
        for trace_id in sorted(lanes):
            lane = lanes[trace_id]
            if len(lane) < 2:
                continue
            ordered = sorted(lane.items(), key=lambda kv: kv[1][0])
            for (ka, (_lo_a, hi_a)), (kb, (lo_b, _hi_b)) in zip(
                    ordered, ordered[1:]):
                flow_id += 1
                common = {"cat": "trace", "name": FLOW_EVENT_NAME,
                          "id": flow_id,
                          "args": {"trace_id": trace_id}}
                events.append({"ph": "s", "pid": ka[0], "tid": ka[1],
                               # the arrow leaves the earlier lane's last
                               # span and lands on the later lane's first,
                               # clamped so s <= f when the lanes overlap
                               "ts": min(hi_a, lo_b), **common})
                events.append({"ph": "f", "bp": "e", "pid": kb[0],
                               "tid": kb[1], "ts": lo_b, **common})
        # -- the router's migration phase lane --------------------------
        migs = self._finalize_migrations()
        if migs:
            rpid = len(files)       # one past the last replica rank
            events.append({"ph": "M", "pid": rpid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": "router:migrations"}})
            for m in migs:
                tid = 100 + int(m["rid"] or 0)
                events.append({"ph": "M", "pid": rpid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": f"migration rid "
                                                f"{m['rid']}"}})
                ts = m["t0"] * 1e6
                for p in MIGRATION_PHASES:
                    v = m["phases"].get(p)
                    if v is None or p == "stitch":
                        continue    # stitch renders on the decode lane
                    dur = max(v * 1e6, 1.0)
                    events.append({
                        "ph": "X", "cat": "migration", "pid": rpid,
                        "tid": tid, "name": f"kv_ship:{p}", "ts": ts,
                        "dur": dur,
                        "args": {"trace_id": m["trace_id"],
                                 "request_id": m["rid"],
                                 "src": m["src"], "dst": m["dst"],
                                 "bytes": m["bytes"]}})
                    ts += dur
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def explain_tail(self, quantile=0.99, top=None):
        """The FLEET-level slow-token explainer: join every replica
        recorder's request timelines by ``trace_id`` into one END-TO-END
        token stream per request (across KV ships, failovers and restarts)
        and classify the worst inter-token gaps. A gap that stayed inside
        one replica gets that replica recorder's own verdict (via
        ``classify_token_gap``); a gap spanning a replica boundary is the
        migration itself (``kv_ship:{phase}``, the recorded migration's
        dominant phase) when one covers it, else a failover
        resubmission's re-prefill window (``failover_resubmit``). Entries
        carry ``trace_id``, ``request_id``/``replica`` of the LATER token,
        ``gap_s``, ``step_id``, ``cause``, and the migration's phase
        seconds when the cause is a ship phase."""
        migs = self._finalize_migrations()
        by_trace = {}
        for m in migs:
            if m["trace_id"] is not None:
                by_trace.setdefault(m["trace_id"], []).append(m)
        streams = {}
        for i, srv in enumerate(self.replicas):
            rec = srv.flight_recorder
            if rec is None:
                continue
            for rid, tl in rec.timelines().items():
                tc = tl.get("trace_ctx")
                key = tc["trace_id"] if tc else (i, rid)
                st = streams.setdefault(
                    key, {"trace_id": tc["trace_id"] if tc else None,
                          "tokens": [], "crashes": []})
                for ev in tl["events"]:
                    if ev["kind"] == "token":
                        st["tokens"].append(
                            (ev["t"], i, rid, ev["step_id"]))
                    elif ev["kind"] == "crashed":
                        st["crashes"].append(ev["t"])
        gaps = []
        for key, st in streams.items():
            toks = sorted(st["tokens"])
            for (t0, i0, _r0, _s0), (t1, i1, r1, s1) in zip(
                    toks, toks[1:]):
                gaps.append((t1 - t0, t0, t1, i0, i1, r1, s1, key, st))
        if not gaps:
            return []
        ordered = sorted(g[0] for g in gaps)
        thresh = ordered[min(int(quantile * len(ordered)),
                             len(ordered) - 1)]
        tail = sorted((g for g in gaps if g[0] >= thresh),
                      key=lambda g: -g[0])
        if top is not None:
            tail = tail[:top]
        out = []
        for gap, t0, t1, i0, i1, rid, sid, key, st in tail:
            entry = {"request_id": rid, "replica": i1,
                     "gap_s": round(gap, 6), "step_id": sid}
            if st["trace_id"] is not None:
                entry["trace_id"] = st["trace_id"]
            if i0 != i1:
                # the stream moved replicas inside this gap: the recorded
                # migration explains it phase by phase, or it was a
                # failover's re-prefill window
                mig = next((m for m in by_trace.get(st["trace_id"], ())
                            if t0 <= m["t1"] and m["t0"] <= t1), None)
                if mig is not None and mig["phases"]:
                    phases = mig["phases"]
                    dom = max(phases, key=phases.get)
                    entry["cause"] = f"kv_ship:{dom}"
                    entry["migration"] = {
                        "src": mig["src"], "dst": mig["dst"],
                        "bytes": mig["bytes"],
                        "phases": {p: round(v, 6)
                                   for p, v in sorted(phases.items())}}
                else:
                    entry["cause"] = "failover_resubmit"
            elif any(t0 < ct <= t1 for ct in st["crashes"]):
                entry["cause"] = "restart_recovery"
            else:
                rec = self.replicas[i1].flight_recorder
                cause, _step = rec.classify_token_gap(rid, sid, gap)
                entry["cause"] = cause
            out.append(entry)
        return out

    def dump_debug_bundle(self, out_dir, reason="manual", detail=None):
        """The fleet postmortem is not ported yet (A11: the per-replica
        black box it bundles)."""
        _unported("the black box (dump_debug_bundle)", "A11")
