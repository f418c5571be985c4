"""LLM serving engine (counterpart: ``paddle_tpu/inference/llm_engine.py``)
over dense per-slot KV buffers or a paged KV pool: the legacy
admit-then-decode scheduler and the fused token-budget scheduler.

What this port serves — ``LLMEngine(cache_impl="dense" | "paged")`` with

* ``scheduler="legacy"`` (the reference's "parity reference for the fused
  path"): a request ADMITS into a free slot by prefilling its whole prompt
  as a train of ``chunk_size`` windows through the static-cache path
  (masked plain attention); every ``step`` decodes one token for every
  active slot, ``horizon`` times;
* ``scheduler="fused"`` (Sarathi-style chunked-prefill + decode fusion,
  how the reference serves): admission is slot ASSIGNMENT only. A step
  with a ramping slot is ONE mixed dispatch: per slot either one bounded
  prefill chunk (``_Slot.prefill_pos`` tracks progress) or one decode
  token, under the per-step token budget ``max_step_tokens``. All-decode
  steps fall through to the legacy decode path (with ``horizon``), or,
  with ``readout_stride=k > 1``, run up to ``k`` decode iterations as ONE
  dispatch read back by ONE sync (multi-step decode, reference
  ``llm_engine.py:1106-1148``): the reference's ``while_loop`` stops on
  the device once no slot is active; eager PyTorch cannot stop without
  reading the device, so the port runs ``min(k, max(budgets))``
  iterations (the host's own upper bound on live rows) with the carried
  activity mask, and rows past the last active one come out all-inactive,
  as the reference's zero rows past its exit do. A request's
  ``readout_stride`` pin caps the stride of every all-decode step it is
  resident in. ``step_finish`` backdates each row's emit stamp to its
  amortized device step boundary (``emit_backdate_s``).

``cache_impl="dense"`` (the reference's default) keeps one zeroed ``[B,
capacity, Hkv, D]`` K and V buffer per layer, a slot's rows at its own
positions. Its admission windows run on the slot's buffer rows (the last
window slides back when it would cross the buffer's end, as the
reference's clamped slice does), its decode steps through
:class:`~paddle_tpu_torch.models.llama.SlotKVCache` and its mixed steps
through :class:`~paddle_tpu_torch.models.llama.ChunkKVCache`: masked
attention, so no flash or paged kernel runs (a model with weight-only
int4 projections still runs B8 in its decode steps). There is no
allocator, no preemption and no pool audit.

``cache_impl="paged"``: legacy admission windows are block-aligned (each
gathers the slot's blocks and scatters its new K/V back) and decode runs
the paged-decode kernel; the fused mixed step runs the paged-append
kernel and blocks allocate chunk by chunk inside the scheduler, exactly
(not chunk-rounded). The block allocator lives on the host (min-heap of
free blocks, one reference per block); when the pool runs dry the newest
slot is PREEMPTED back to the waiting queue and re-prefills on
re-admission, so greedy output is unchanged.

Both are greedy (``temperature <= 0``) from the carried logits; eos,
budget and capacity deactivate a slot on the device, and the host retires
it at readout.

``speculative_k=k > 1`` serves speculative VERIFY windows (reference
``llm_engine.py:1156-1371``, ``:3905-4149``): each window commits the
token sampled from the carried logits plus up to ``k - 1`` prompt-lookup
drafts read on the device from a ``[B, capacity]`` token history
(``_lookup_draft``), all verified by ONE model call over the window.
Acceptance is the coupled greedy rule (``_verify_window``): draft j
survives iff it equals the argmax at its position and every earlier
draft did, so the stream is the plain engine's token for token; rejected
tails roll back through the lens. Two schedulers carry it:

* legacy, dense only (the reference's default speculation, ``spec_step``,
  ``llm_engine.py:1212-1268``): every all-decode step runs ``horizon``
  full-width windows through :class:`SlotKVCache` (``_spec_scan``), the
  host's bound ``min(horizon, max(budgets))`` of them, since every window
  commits a token a live slot. Its readout books each window's full grant
  as proposed; it pipelines to depth 2, like the legacy dense engine;
* fused, dense or bf16 paged: in a mixed step a decode slot takes a
  verify grant inside the chunk (paged: the paged-append kernel; dense:
  :class:`ChunkKVCache`); an all-decode step runs up to
  ``readout_stride`` windows per dispatch, again ``min(stride,
  max(budgets))``. Draft counts adapt to each request's acceptance EWMA,
  kept in an rid-keyed mirror that survives :meth:`LLMEngine.reset` (the
  legacy readout updates it too); a paged pool releases the blocks past
  the slot's scheduled length at readout. Fused speculation pipelines to
  depth 2.

Pipelining: ``step_begin`` enqueues its work and returns without waiting
on the device. Host arrays go up through pinned staging buffers owned by
the dispatch, the step's token and activity rows come back into pinned
host memory, and a CUDA event marks the step's end; ``step_finish`` waits
on that event only. Up to ``max_pipeline_depth()`` steps may be in flight
(the reference's contract: dense fused 3, dense legacy 2, paged fused 3
or 2, paged legacy 1). Host state is then up to ``depth - 1`` steps
stale: the in-graph guards deactivate finished slots on the device, a
slot that finished in flight keeps dispatching until its first readout,
and later pendings drop its column by the slot-identity check. The fused
engine keeps a host mirror of each slot's scheduled length
(``_Slot.sched_len``); on a paged pool the in-flight WRITE FENCE parks a
block freed while a dispatch may still write it in quarantine until that
dispatch lands.

The K/V pools ``[n_blocks + 1, Hkv, block_size, D]`` per layer live on the
engine's device and are updated IN PLACE (the reference is functional and
donates its buffers), as are the dense buffers. The trailing block is
scratch: the kernels park there the writes of slots whose target table
entry is -1. ``kv_cache_dtype="int8"|"int4"`` makes them quantized pools:
int8 payload ``[n_blocks + 1, Hkv, block_size, kv_packed_dim(D)]`` with
one float32 scale per (block, kv head) beside each
(``_k_scale``/``_v_scale``); the paged kernels dequantize on read and
requantize what they write (kernel B4), and the legacy admission prefill
gathers dequantized blocks and scatters requantized ones.

For :class:`~paddle_tpu_torch.serving.AsyncLLMServer` the engine keeps the
reference's serving surface: ``reset`` (crash recovery), ``cancel``,
``reset_stats``, ``throughput``, re-admission with ``committed_tokens``,
the ``fault_injector`` hooks at ``step_begin``/``step_finish``,
``emit_backdate_s`` and the pool-capacity accounting (``kv_pool_nbytes``,
``kv_bytes_per_block``, ``kv_pool_effective_blocks``; 0 on a dense
engine). An attached :class:`~paddle_tpu_torch.profiler.FlightRecorder`
(``flight_recorder``) gets one ``StepRecord`` per dispatch (decode,
mixed, or a "drain" of preemptions and retirements alone) and every
emitted token stamped with its step id, as the reference's engine emits
them.

``enable_prefix_cache=True`` (paged only) makes the allocator a
ref-counted, content-addressed store (reference ``llm_engine.py:2119-2356``):
every full block is keyed by a blake2b hash chained over the whole prefix,
blocks freed at refcount 0 park in an LRU of cached content instead of
the free heap, and admission attaches the longest cached prefix by table
writes and refcount bumps (legacy: whole chunks; fused: whole blocks plus
a copy-on-write tail, a private clone of a cached block whose leading
tokens continue the prompt). Shared blocks are never written. Allocation
evicts the oldest LRU block before any slot is preempted.

``add_request`` takes the reference's keyword arguments: a
``readout_stride`` pin (live on a stride engine, inert on a stride-1
one), ``spec_ewma`` (the acceptance EWMA seed of a speculative engine,
inert without speculation) and ``trace_ctx``
(stamped on an attached recorder) are stored on the request; embedding
requests (ROADMAP A10) and KV export (A8(h)) raise
``NotImplementedError``.

Not in this port yet (each raises ``NotImplementedError``): verify
windows over int8/int4 pools (ROADMAP A8(e), second half), LoRA
adapters, the host KV tier and meshes;
sampling with ``temperature > 0`` waits for the threefry port (ROADMAP
A7). The reference's
``PADDLE_TPU_TRANSFER_CHECKS=1`` stride guard (a thread-local
``jax.transfer_guard``) has no thread-local torch form and is not ported
(ROADMAP A11).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import heapq
import os
import time
import warnings

import numpy as np
import torch

from ..core.device import resolve_device
from ..incubate.nn.functional import _kv_quant_gather
from ..models.llama import (ChunkKVCache, PagedKVCache, SlotKVCache,
                            StaticKVCache)
from ..ops.kernels.paged_attention import (kv_block_scale, kv_packed_dim,
                                           kv_quantize)

__all__ = ["LLMEngine", "GenerationRequest", "RequestOutput", "PendingStep",
           "PoolCapacityError", "default_engine_stats"]


def default_engine_stats():
    """Fresh engine ``stats`` dict: the reference's keys that this
    engine's paths touch (the server reads them by name)."""
    return {"steps": 0, "prefill_chunks": 0, "tokens_generated": 0,
            "draft_tokens_accepted": 0,
            "spec_proposed_tokens": 0, "spec_accepted_tokens": 0,
            "preemptions": 0, "prefill_tokens": 0, "fused_steps": 0,
            "multi_steps": 0,
            "prefix_hit_tokens": 0, "prefix_cow_blocks": 0,
            "prefix_evicted_blocks": 0,
            "decode_time_s": 0.0, "admit_time_s": 0.0,
            "dispatch_time_s": 0.0, "host_sync_time_s": 0.0,
            "emit_time_s": 0.0}


#: chain-hash seed of block 0 of every sequence (reference
#: ``llm_engine.py:99``): equal first blocks collide, across packages too
_ROOT_HASH = b"paddle-tpu-prefix-root"

#: smoothing of the per-request draft-acceptance EWMA behind the
#: acceptance-adaptive verify grants (reference ``llm_engine.py:101-106``):
#: a request whose drafts stop accepting sheds its window within a few
#: readouts, one unlucky window does not collapse it
_SPEC_EWMA_ALPHA = 0.4


def _lookup_draft(tokens_buf, lens, k_draft, ngram):
    """Prompt-lookup drafting on the device, batched (reference
    ``llm_engine.py:4576-4601``): match each row's last ``ngram`` committed
    tokens against its history ``tokens_buf [B, cap]`` (the most recent
    match wins) and propose the ``k_draft`` tokens that followed it, else
    repeat the last token. Returns ``[B, k_draft]`` int32.

    The reference's slices clamp as ``jax.lax.dynamic_slice`` does: the
    tail starts at ``max(L - ngram, 0)`` clamped into ``[0, cap - ngram]``
    (so when ``L < ngram`` it reads the zeros past ``L``), the
    continuation is read at its start clamped into ``[0, cap - k_draft]``
    while the ``pos < L`` mask uses the unclamped start, the last token is
    read at ``L - 1`` clamped into the buffer, and the match compares
    through ``roll``'s wrap-around. Index tensors and ``gather``
    keep all of it on the device: nothing here reads back to the host."""
    B, cap = tokens_buf.shape
    dev = tokens_buf.device
    L = lens.to(torch.long)
    idx = torch.arange(cap, device=dev)
    tail_start = (L - ngram).clamp(min=0).clamp(max=cap - ngram)
    tail = tokens_buf.gather(
        1, tail_start[:, None] + torch.arange(ngram, device=dev)[None])
    eq = torch.ones((B, cap), dtype=torch.bool, device=dev)
    for j in range(ngram):
        # buf[(i + j) % cap] == tail[j] at every window position i
        eq = eq & (torch.roll(tokens_buf, -j, dims=1) == tail[:, j:j + 1])
    m = eq & (idx[None] < (L - ngram)[:, None])   # not the tail itself
    # the most recent match: the largest matching index (-1: none)
    i_star = torch.where(m, idx[None], torch.full_like(idx[None], -1)) \
        .amax(dim=1)
    has = i_star >= 0
    start = torch.where(has, i_star + ngram, torch.zeros_like(i_star))
    kidx = torch.arange(k_draft, device=dev)[None]
    cont = tokens_buf.gather(
        1, start.clamp(0, cap - k_draft)[:, None] + kidx)
    # JAX clamps an out-of-range index: a pipelined over-dispatch of the
    # legacy scan drafts at a length past the buffer
    last = tokens_buf.gather(1, (L - 1).clamp(0, cap - 1)[:, None])
    pos = start[:, None] + kidx
    return torch.where(has[:, None] & (pos < L[:, None]), cont, last) \
        .to(torch.int32)


def _write_window(tokens_buf, window, lens, mask=None):
    """Append each row's verify ``window [B, Kw]`` to its history at its
    own length, the start clamped into ``[0, cap - Kw]`` as the
    reference's dynamic update clamps it (``llm_engine.py:4604-4612``),
    for the rows where ``mask [B]`` holds (None: every row, as the legacy
    scan writes); in place. Rejected-tail positions are overwritten by
    later windows."""
    cap, Kw = tokens_buf.shape[1], window.shape[1]
    cols = lens.to(torch.long).clamp(0, cap - Kw)[:, None] + \
        torch.arange(Kw, device=tokens_buf.device)[None]
    new = window.to(torch.int32)
    if mask is not None:
        new = torch.where(mask[:, None], new, tokens_buf.gather(1, cols))
    tokens_buf.scatter_(1, cols, new)


def _verify_window(logits_win, draft, q_eff, active):
    """The coupled greedy acceptance rule over ONE verify window (reference
    ``verify_window``, ``llm_engine.py:1183-1210``): ``logits_win [B, Kw,
    V]`` are the window rows' logits, ``draft [B, Kw - 1]`` the proposals,
    ``q_eff [B]`` the granted widths (rows past one never accept). Draft j
    survives iff it equals the argmax at its position, every earlier draft
    did, and ``j < q_eff - 1``. Returns ``(counts, next_logits)``:
    committed tokens per slot (1 + accepted drafts, 0 when inactive) and
    the logits at the row after the last accepted draft, the plain
    engine's carried state after those tokens."""
    Kd = draft.shape[1]
    targets = torch.argmax(logits_win[:, :Kd], dim=-1).to(torch.int32)
    acc = (targets == draft) & (
        torch.arange(Kd, device=draft.device)[None] <
        (q_eff.to(torch.long) - 1)[:, None])
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1) \
        .to(torch.int32)
    counts = torch.where(active, 1 + n_acc, torch.zeros_like(n_acc))
    next_logits = logits_win.gather(
        1, n_acc.to(torch.long)[:, None, None].expand(
            -1, 1, logits_win.shape[-1]))[:, 0]
    return counts, next_logits


class PoolCapacityError(RuntimeError):
    """The head waiting request's prompt cannot prefill into the paged
    pool at all (``kv_pool_blocks`` too small)."""


@dataclasses.dataclass
class GenerationRequest:
    request_id: int
    prompt_ids: np.ndarray           # [P] int32
    max_new_tokens: int = 64
    temperature: float = 0.0         # <=0 -> greedy
    top_p: float = 1.0
    eos_token_id: int | None = None
    #: the reference's per-request fields, stored as given: a multi-step
    #: readout pin (inert at ``readout_stride=1``), the tenant (0 = the
    #: base model), the grant kind, the speculation EWMA seed (inert
    #: without speculation), the KV-export flag and the trace context
    readout_stride: int | None = None
    adapter_id: int = 0
    kind: str = "generate"
    spec_ewma: float | None = None
    export_kv: bool = False
    trace_ctx: object | None = None


@dataclasses.dataclass
class RequestOutput:
    request_id: int
    token_ids: list
    finished: bool = False
    finish_reason: str | None = None


class _Slot:
    __slots__ = ("req", "generated", "prompt_len", "prefill_pos", "inflight",
                 "chain", "reg_blocks")

    def __init__(self, req, prompt_len, prefill_pos=None):
        self.req = req
        self.generated = []
        self.prompt_len = prompt_len
        #: prefix cache: the chain hash of each registered full block of
        #: the slot's committed stream, and how many are registered
        #: (admission seeds both from the probe's hit)
        self.chain = []
        self.reg_blocks = 0
        #: prompt tokens whose prefill has been DISPATCHED (== prompt_len
        #: once ramp-in completes; legacy admission prefills everything up
        #: front). The fused scheduler advances it one chunk grant at a time
        self.prefill_pos = prompt_len if prefill_pos is None else prefill_pos
        #: decode tokens dispatched but not yet read back — the fused
        #: engine's host mirror of the device lens under pipelining
        self.inflight = 0

    @property
    def ramping(self):
        return self.prefill_pos < self.prompt_len

    def sched_len(self):
        """Scheduled sequence length: what the device lens will be once
        every dispatched step lands."""
        return self.prefill_pos + len(self.generated) + self.inflight


class PendingStep:
    """One dispatched step: ``[rows, B]`` token and activity histories in
    host memory (pinned on the card, filled by copies that complete before
    ``event``), read back by :meth:`LLMEngine.step_finish`. ``slots``
    snapshots the slot objects at dispatch time; ``sched`` is the per-slot
    decode growth the dispatch scheduled (the fused engine pays it back off
    ``_Slot.inflight``); ``fenced`` lists the blocks it may write;
    ``event`` is the CUDA event recorded after its work (None on the
    CPU, where the work has run by the time ``step_begin`` returns).
    ``step_id`` is the flight recorder's StepRecord id (None without a
    recorder); ``t_dispatch`` the ``perf_counter`` at dispatch, over which
    the readout amortizes a multi-row stride's emit stamps; ``kind`` the
    dispatch's kind ("decode", "mixed" or "spec"; None for a drain).

    A speculative dispatch (``spec``) reads back ``[windows, B, Kw]``
    window tokens, ``[windows, B]`` committed ``counts``, activity and, from
    the fused programs, ``offered`` widths (1 + drafts after the in-graph
    clamps, what the acceptance accounting books; None from the legacy
    scan, which never clamps); ``verify`` maps each verify slot to the
    drafts it was granted: what a legacy window proposes, and the key of
    the paged block-table rollback."""

    __slots__ = ("toks", "was_active", "slots", "pool_done", "sched",
                 "fenced", "event", "step_id", "t_dispatch", "kind",
                 "spec", "counts", "offered", "verify")

    def __init__(self, toks, was_active, slots, pool_done, sched=None,
                 fenced=None, event=None, kind=None, counts=None,
                 offered=None, verify=None):
        self.toks = toks
        self.was_active = was_active
        self.slots = slots
        self.pool_done = pool_done
        self.sched = sched or {}
        self.fenced = fenced or []
        self.event = event
        self.step_id = None
        self.t_dispatch = None
        self.kind = kind
        self.spec = counts is not None
        self.counts = counts
        self.offered = offered
        self.verify = verify or {}


def _unported(what, item):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class LLMEngine:
    """Continuous-batching engine over dense slot buffers or a paged KV
    pool for a ``paddle_tpu_torch`` ``LlamaForCausalLM``. The signature and
    defaults are the reference's (``cache_impl="dense"``); values outside
    this port raise ``NotImplementedError``. ``device`` defaults to the
    card and must hold the model.

    ``scheduler="fused"``: per-step token budget ``max_step_tokens``
    (default ``chunk_size + max_batch - 1``: one full chunk plus a decode
    token for every other slot; decode tokens are always granted, the
    budget bounds prefill interference). ``readout_stride=k > 1`` (fused
    only, not with ``horizon > 1``) runs all-decode steps as up to ``k``
    decode iterations per dispatch and readout. ``speculative_k=k > 1``
    verifies windows of 1 + up to ``k - 1`` prompt-lookup drafts
    (``lookup_ngram`` tokens matched): ``horizon`` full windows a step
    under the legacy scheduler (dense only), adaptive verify grants under
    the fused one (dense or bf16 paged)."""

    def __init__(self, model, max_batch=4, max_seq_len=None, chunk_size=64,
                 top_k=0, stream_callback=None, horizon=1, speculative_k=1,
                 lookup_ngram=3, mesh=None, cache_impl="dense",
                 block_size=64, kv_pool_blocks=None, scheduler="legacy",
                 max_step_tokens=None, enable_prefix_cache=False,
                 readout_stride=1, adapter_store=None,
                 adapter_cache_slots=4, kv_cache_dtype=None,
                 kv_host_swap=False, kv_host_spill_bytes=0,
                 sampling_seed=None, device=None):
        if enable_prefix_cache and cache_impl != "paged":
            raise ValueError("enable_prefix_cache needs cache_impl='paged' "
                             "(content-hashed block reuse lives in the "
                             "paged pool's table indirection)")
        if kv_cache_dtype is not None:
            if kv_cache_dtype not in ("int8", "int4"):
                raise ValueError(
                    f"unknown kv_cache_dtype {kv_cache_dtype!r} "
                    f"(supported: 'int8', 'int4', None)")
            if cache_impl != "paged":
                raise ValueError(
                    "kv_cache_dtype needs cache_impl='paged': per-block "
                    "quantization scales live at the paged pool's block "
                    "granularity")
        if cache_impl not in ("dense", "paged"):
            raise ValueError(f"unknown cache_impl {cache_impl!r}")
        if scheduler not in ("legacy", "fused"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        #: speculative verify windows: 1 committed token + up to k - 1
        #: prompt-lookup drafts a window
        self.speculative_k = max(1, int(speculative_k))
        self.lookup_ngram = max(1, int(lookup_ngram))
        if self.speculative_k > 1:
            # the reference's ValueErrors first (llm_engine.py:572-575,
            # :641-645, :678-682), so a configuration it rejects is
            # rejected alike; then the form not ported yet
            if scheduler == "fused" and int(chunk_size) < self.speculative_k:
                raise ValueError(
                    f"chunk_size {int(chunk_size)} cannot carry a "
                    f"speculative_k={self.speculative_k} verify window "
                    f"(the fused mixed step's ids buffer is chunk tokens "
                    f"wide)")
            if cache_impl == "paged" and scheduler != "fused":
                raise ValueError(
                    "the legacy scheduler's speculative path is dense-only "
                    "— paged speculation rides the fused scheduler's "
                    "verify grants through the append-form attention path "
                    "(scheduler='fused')")
            if adapter_store is not None and scheduler != "fused":
                raise ValueError(
                    "the legacy speculative scan is not adapter-aware — "
                    "batched multi-LoRA speculation rides the fused "
                    "scheduler's verify grants (scheduler='fused')")
            if kv_cache_dtype is not None:
                _unported(f"verify windows over {kv_cache_dtype} KV pools "
                          f"(speculative_k > 1 with kv_cache_dtype)",
                          "A8(e), second half")
        #: multi-step all-decode (fused scheduler): up to this many decode
        #: iterations per dispatch, capped per step by the resident
        #: slots' pins (reference ``llm_engine.py:498-517``)
        self.readout_stride = max(1, int(readout_stride))
        if self.readout_stride > 1:
            if scheduler != "fused":
                raise ValueError(
                    "readout_stride > 1 needs scheduler='fused' (the "
                    "legacy scheduler already amortizes host syncs with "
                    "`horizon`; the stride is the fused scheduler's "
                    "all-decode fast path)")
            if int(horizon) > 1:
                raise ValueError(
                    "readout_stride generalizes `horizon` for the fused "
                    "scheduler's all-decode steps — set one, not both")
        if adapter_store is not None:
            _unported("adapter_store (batched multi-LoRA)", "A10")
        if kv_host_swap or kv_host_spill_bytes:
            _unported("the host KV tier", "A8(g)")
        if mesh is not None:
            _unported("mesh (multi-process / tensor-parallel serving)", "A14")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine device "
                             f"is {self.device}")
        self.model = model
        self.scheduler = scheduler
        self.cache_impl = cache_impl
        self.prefix_cache = bool(enable_prefix_cache)
        #: KV-pool quantization mode (None = bf16 pools)
        self.kv_quant = kv_cache_dtype
        c = model.config
        self.B = int(max_batch)
        self.horizon = max(1, int(horizon))
        self.capacity = int(max_seq_len or c.max_position_embeddings)
        if self.capacity > c.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {self.capacity} exceeds rope table "
                f"({c.max_position_embeddings})")
        self.chunk = min(int(chunk_size), self.capacity)
        #: fused-scheduler per-step token cap: sum over slots of (prefill
        #: chunk grant | 1 decode token)
        self.max_step_tokens = int(max_step_tokens) if max_step_tokens \
            else self.chunk + self.B - 1
        if self.max_step_tokens < 1:
            raise ValueError(f"max_step_tokens must be >= 1, got "
                             f"{self.max_step_tokens}")
        self.stream_callback = stream_callback
        self._paged = cache_impl == "paged"
        #: allocator audit after every alloc/free, on under
        #: PADDLE_TPU_POOL_CHECKS=1 (as in the reference; paged only)
        self._debug_pool = False
        if self._paged:
            self.block_size = int(block_size)
            if self.chunk % self.block_size:
                raise ValueError(f"chunk_size {self.chunk} must be a "
                                 f"multiple of block_size {self.block_size}")
            if self.capacity % self.chunk:
                raise ValueError(f"capacity {self.capacity} must be a "
                                 f"multiple of chunk_size {self.chunk} "
                                 f"under paged KV")
            self._max_blocks = self.capacity // self.block_size
            self.n_blocks = int(kv_pool_blocks or self.B * self._max_blocks)
            self._debug_pool = os.environ.get(
                "PADDLE_TPU_POOL_CHECKS", "0") not in ("", "0")
        self._kvh = c.num_key_value_heads
        self._head_dim = c.hidden_size // c.num_attention_heads
        self._n_layers = c.num_hidden_layers
        self._dtype = model.llama.embed_tokens.weight.dtype
        self._admit_order = [0] * self.B
        self._admit_seq = 0
        #: rid -> draft-acceptance EWMA, the acceptance-adaptive verify-k
        #: state; survives reset() so a restarted request resumes at its
        #: learned window, and drops at the request's finish
        self._spec_ewma = {}
        self._init_device_state()
        #: pool bytes, payload and scales (what a StepRecord carries)
        self._kv_nbytes = self.kv_pool_nbytes()
        self.slots: list[_Slot | None] = [None] * self.B
        self.waiting: collections.deque[GenerationRequest] = \
            collections.deque()
        self.finished_outputs: dict[int, RequestOutput] = {}
        self._next_id = 0
        #: tokens a preempted request committed before eviction, stitched
        #: back in front of its post-readmission stream at finish
        self._preempted_prefix = {}
        #: dispatched steps not yet finished (<= max_pipeline_depth())
        self._inflight = 0
        #: optional FaultInjector (serving.faults): scripted chaos fires at
        #: the step_begin/step_finish hooks; None costs one attribute check
        self.fault_injector = None
        #: optional FlightRecorder (profiler.flight_recorder): when attached
        #: and enabled, each dispatch emits one StepRecord and each emitted
        #: token its step id; None costs one attribute check a step
        self.flight_recorder = None
        self._rec_ctx = None       # per-step_begin wall-split anchors
        self._rec_preempted = []   # rids parked by _preempt_slot this step
        #: seconds the current token's emit stamp is backdated by (the
        #: reference amortizes multi-row readouts; one-row steps: 0.0)
        self.emit_backdate_s = 0.0
        self.stats = default_engine_stats()

    # ------------------------------------------------------------------
    # device state
    # ------------------------------------------------------------------
    def _init_device_state(self):
        """(Re)build the KV buffers, carried logits and lens: on a dense
        engine one zeroed ``[B, capacity, Hkv, D]`` K and V buffer per
        layer; on a paged one the pools (with the trailing scratch block;
        quantized pools with their scale arrays: zero payload under zero
        scales is the same cold state) and the host allocator. Called by
        ``__init__`` and :meth:`reset`."""
        dev = self.device
        L = self._n_layers
        self._logits = torch.zeros((self.B, self.model.config.vocab_size),
                                   dtype=torch.float32, device=dev)
        self._lens = torch.zeros((self.B,), dtype=torch.int32, device=dev)
        #: the committed-token history the prompt-lookup drafts read
        #: (speculative engines only): each slot's stream, zero past it
        self._tokens = torch.zeros((self.B, self.capacity), dtype=torch.int32,
                                   device=dev) \
            if self.speculative_k > 1 else None
        self._k_scale = self._v_scale = [None] * L
        if not self._paged:
            shape = (self.B, self.capacity, self._kvh, self._head_dim)
            self._k = [torch.zeros(shape, dtype=self._dtype, device=dev)
                       for _ in range(L)]
            self._v = [torch.zeros(shape, dtype=self._dtype, device=dev)
                       for _ in range(L)]
            return
        dp = kv_packed_dim(self._head_dim, self.kv_quant)
        pool_shape = (self.n_blocks + 1, self._kvh, self.block_size, dp)
        pool_dtype = torch.int8 if self.kv_quant else self._dtype
        self._k = [torch.zeros(pool_shape, dtype=pool_dtype, device=dev)
                   for _ in range(L)]
        self._v = [torch.zeros(pool_shape, dtype=pool_dtype, device=dev)
                   for _ in range(L)]
        if self.kv_quant:
            scale_shape = (self.n_blocks + 1, self._kvh)
            self._k_scale = [torch.zeros(scale_shape, dtype=torch.float32,
                                         device=dev) for _ in range(L)]
            self._v_scale = [torch.zeros(scale_shape, dtype=torch.float32,
                                         device=dev) for _ in range(L)]
        self._tables = np.full((self.B, self._max_blocks), -1, np.int32)
        #: min-heap of free physical blocks: allocation pops the smallest
        #: index, so the layout is a pure function of the request sequence
        self._free_blocks = list(range(self.n_blocks))
        self._slot_blocks = [[] for _ in range(self.B)]
        self._block_ref = [0] * self.n_blocks
        #: in-flight write fence: physical block -> dispatches that may
        #: still write it; a block freed while fenced waits in quarantine
        self._write_fence = {}
        self._quarantine = set()
        # the content-addressed store (enable_prefix_cache): chain hash ->
        # phys for every registered full block, and per block its hash,
        # parent hash and token bytes; parent hash -> registered children
        self._store = {}
        self._block_hash = {}
        self._block_parent = {}
        self._block_tokens = {}
        self._children = {}
        #: refcount-0 registered blocks, oldest freed first: allocation
        #: evicts from here before any slot is preempted
        self._lru = collections.OrderedDict()

    def reset(self):
        """Tear the engine down to EMPTY and re-arm it: the supervised
        server's crash-recovery hook. Every slot, waiting request, finished
        output and preemption stitch drops, and the pools (scale arrays
        included), carried logits, lens and allocator are rebuilt from
        zeros (the token history too), and the prefix store empties. The
        request-id counter, the cumulative ``stats`` and the rid-keyed
        acceptance EWMA mirror survive."""
        self.slots = [None] * self.B
        self.waiting.clear()
        self.finished_outputs.clear()
        self._preempted_prefix.clear()
        self._inflight = 0
        self._admit_order = [0] * self.B
        self._rec_ctx = None
        self._rec_preempted = []
        self._init_device_state()
        self._check_pool_invariants()
        return self

    def reset_stats(self):
        for key in self.stats:
            self.stats[key] = 0.0 if key.endswith("_s") else 0

    def throughput(self):
        """Tokens generated per second of decode time (dispatch and
        readout wait of every step, as the reference books it)."""
        dt = self.stats["decode_time_s"]
        return self.stats["tokens_generated"] / dt if dt > 0 else 0.0

    # ------------------------------------------------------------------
    # KV-pool capacity accounting
    # ------------------------------------------------------------------
    def kv_pool_nbytes(self):
        """Device bytes of the K/V pools INCLUDING the scale arrays, summed
        off the real tensors; 0 on a dense engine, as in the reference."""
        if not self._paged:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (*self._k, *self._v, *self._k_scale,
                             *self._v_scale) if t is not None)

    def kv_bytes_per_block(self):
        """Device bytes one pool block costs across all layers (K + V
        payload plus its per-head scales): what an equal-bytes pool sizing
        divides a memory budget by; 0 on a dense engine."""
        if not self._paged:
            return 0
        return self.kv_pool_nbytes() // (self.n_blocks + 1)

    def kv_pool_effective_blocks(self):
        """Pool capacity in unquantized-equivalent blocks: ``n_blocks`` on
        an unquantized pool, ~2x/~4x under int8/int4 (less the scales); 0
        on a dense engine."""
        if not self._paged:
            return 0
        if not self.kv_quant:
            return self.n_blocks
        unquant = self._n_layers * 2 * self._kvh * self.block_size * \
            self._head_dim * torch.empty((), dtype=self._dtype).element_size()
        return int(self.n_blocks * unquant
                   // max(self.kv_bytes_per_block(), 1))

    def max_pipeline_depth(self):
        """How many ``step_begin()`` dispatches may be in flight at once
        (the reference's contract): fused dense 3 — every grant reads the
        host lens mirror, and the in-graph guards and the slot-identity
        check absorb host state up to two steps stale; fused paged on a
        full pool 3 — allocation cannot fail in steady state; fused paged
        on an oversubscribed pool 2 — the write fence makes mid-flight
        eviction memory-safe, but each stale step a preemption decision
        lags costs re-prefill churn; fused speculative 2 — the verify
        grants' lens mirror overestimates in-flight growth by every
        rejected tail (the device rolls back, the host learns at readout),
        so each extra stale dispatch over-fences and over-allocates a
        window a slot; legacy dense 2, speculative or not — host request
        state one step stale at the chained dispatch; legacy paged 1 — its
        slots have no lens mirror, so the allocator and the admission
        prefill need each step's post-readout lens."""
        if self.scheduler == "fused":
            if self.speculative_k > 1:
                return 2
            if not self._paged or self.n_blocks >= self.B * self._max_blocks:
                return 3
            return 2
        return 1 if self._paged else 2

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens=64, temperature=0.0,
                    top_p=1.0, eos_token_id=None, request_id=None,
                    committed_tokens=None, readout_stride=None,
                    adapter_id=0, kind="generate", spec_ewma=None,
                    export_kv=False, trace_ctx=None):
        """Queue one request. ``committed_tokens``: tokens ALREADY
        generated for it in a previous life (a supervised restart's or a
        failover's re-admission): they join the prompt for prefill, like a
        preemption, so the stream CONTINUES — only new tokens reach the
        stream callback, the output prepends the committed ones, and
        ``max_new_tokens`` counts new tokens only.

        The reference's other keyword arguments, validated as it does
        (``llm_engine.py:1902-1975``): ``readout_stride`` (a latency-tier
        pin, >= 1: every all-decode step the request is resident in runs
        at most this stride; inert on a stride-1 engine), ``adapter_id``
        (nonzero needs an adapter store, which this port does not have
        yet), ``kind`` ("generate"; "embed" is ROADMAP A10), ``spec_ewma``
        (a carried draft-acceptance EWMA seeding the request's verify
        windows; None takes the engine's rid-keyed mirror, so a restart or
        a preemption resumes at the learned window; inert without
        speculation), ``export_kv`` (ROADMAP A8(h)) and
        ``trace_ctx`` (stamped on an attached flight recorder's
        timeline). All are stored on the request."""
        ids = np.asarray(
            prompt_ids.cpu().numpy() if isinstance(prompt_ids, torch.Tensor)
            else prompt_ids, dtype=np.int32).reshape(-1)
        if len(ids) == 0:
            raise ValueError("empty prompt")
        if readout_stride is not None and int(readout_stride) < 1:
            raise ValueError(f"readout_stride must be >= 1, got "
                             f"{readout_stride}")
        adapter_id = int(adapter_id or 0)
        if adapter_id:
            raise ValueError(
                f"adapter_id {adapter_id} on an engine without an "
                f"adapter_store (LLMEngine(adapter_store=...))")
        if kind not in ("generate", "embed"):
            raise ValueError(f"unknown request kind {kind!r}")
        if kind == "embed":
            _unported("embedding (prefill-only) requests", "A10")
        if export_kv:
            _unported("export_kv (cross-replica KV shipping)", "A8(h)")
        if float(temperature) > 0.0:
            _unported("sampling with temperature > 0 (threefry fold_in keys)",
                      "A7")
        committed = [int(t) for t in committed_tokens] \
            if committed_tokens else []
        if committed:
            ids = np.concatenate([ids, np.asarray(committed, np.int32)])
        if len(ids) >= self.capacity - self.speculative_k:
            raise ValueError(f"prompt of {len(ids)} tokens leaves no room "
                             f"to generate (engine capacity "
                             f"{self.capacity})")
        rid = self._next_id if request_id is None else request_id
        if request_id is not None and (
                rid in self.finished_outputs
                or any(r.request_id == rid for r in self.waiting)
                or any(s is not None and s.req.request_id == rid
                       for s in self.slots)):
            raise ValueError(f"duplicate request_id {rid!r}")
        self._next_id = max(self._next_id, rid) + 1
        if committed:
            # the preemption stitch: _finish_tokens pops this and prepends
            # it to whatever the slot generates from here on
            self._preempted_prefix[rid] = \
                self._preempted_prefix.pop(rid, []) + committed
        self.waiting.append(GenerationRequest(
            rid, ids, int(max_new_tokens), float(temperature), float(top_p),
            eos_token_id,
            readout_stride=(int(readout_stride)
                            if readout_stride is not None else None),
            adapter_id=adapter_id, kind=kind,
            spec_ewma=(float(spec_ewma) if spec_ewma is not None
                       else self._spec_ewma.get(rid)),
            export_kv=bool(export_kv), trace_ctx=trace_ctx))
        if trace_ctx is not None:
            rec = self._rec()
            if rec is not None:
                # direct-engine admissions stamp the timeline here; a
                # server's submit already stamped its own recorder
                # (set_trace_ctx is idempotent for the same context)
                rec.set_trace_ctx(rid, trace_ctx if isinstance(
                    trace_ctx, dict) else trace_ctx.to_dict())
        return rid

    def has_unfinished(self):
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def cancel(self, request_id, reason="cancelled"):
        """Cancel a waiting or running request. Returns its partial
        RequestOutput (finish_reason ``reason``; the server passes
        'deadline' for expiries), or None if the id is unknown or
        finished. A running slot frees at once, pool blocks included (a
        block an in-flight dispatch may still write waits in quarantine)."""
        for i, req in enumerate(self.waiting):
            if req.request_id == request_id:
                del self.waiting[i]
                out = RequestOutput(request_id, self._finish_tokens(req, []),
                                    True, reason)
                self.finished_outputs[request_id] = out
                return out
        for b, slot in enumerate(self.slots):
            if slot is not None and slot.req.request_id == request_id:
                out = RequestOutput(
                    request_id,
                    self._finish_tokens(slot.req, slot.generated), True,
                    reason)
                self.finished_outputs[request_id] = out
                self._free_slot(b)
                return out
        return None

    # ------------------------------------------------------------------
    # paged-pool allocator (host side; tables upload with every dispatch)
    # ------------------------------------------------------------------
    def _n_allocatable(self):
        """Blocks a new allocation may claim: the free ones plus the LRU
        of cached content, which is evicted before any slot is
        preempted."""
        return len(self._free_blocks) + len(self._lru)

    def _pop_block(self):
        """One writable block: the smallest free index, else the oldest
        LRU block, whose content identity is unregistered."""
        if self._free_blocks:
            return heapq.heappop(self._free_blocks)
        phys, _ = self._lru.popitem(last=False)
        self._unregister(phys)
        self.stats["prefix_evicted_blocks"] += 1
        return phys

    def _alloc_blocks(self, slot_idx, n):
        """Grow slot ``slot_idx`` by ``n`` private blocks (refcount 1,
        unregistered). False = pool dry."""
        if self._n_allocatable() < n:
            return False
        blocks = self._slot_blocks[slot_idx]
        for _ in range(n):
            phys = self._pop_block()
            self._block_ref[phys] = 1
            self._tables[slot_idx, len(blocks)] = phys
            blocks.append(phys)
        self._check_pool_invariants()
        return True

    def _release_block(self, phys):
        """Drop one reference. At refcount 0 the FENCE is authoritative: a
        block an in-flight dispatch may still write parks in quarantine
        (never in a pool allocation hands out from) until that dispatch
        lands. Registered blocks can be fenced: a mixed step's prefill
        grant registers the blocks it fills at dispatch."""
        self._block_ref[phys] -= 1
        if self._block_ref[phys] > 0:
            return
        if self._write_fence.get(phys):
            self._quarantine.add(phys)
        else:
            self._park_free_block(phys)

    def _park_free_block(self, phys):
        """Where an unfenced refcount-0 block goes, for release and the
        quarantine drain alike: the LRU if its content is registered (it
        stays probe-able), the free heap otherwise."""
        if phys in self._block_hash:
            self._lru[phys] = None
        else:
            heapq.heappush(self._free_blocks, phys)

    def _fence_blocks(self, b, lo, hi, fenced):
        """Fence every block of slot ``b`` covering positions [lo, hi]:
        the dispatch being built may write them, so until its step_finish
        they must not be handed to a new owner. ``lo`` is the slot's
        committed length (not its scheduled one), so the fence is
        conservative."""
        bs = self.block_size
        blocks = self._slot_blocks[b]
        for blk in range(lo // bs, min(hi // bs + 1, len(blocks))):
            phys = blocks[blk]
            self._write_fence[phys] = self._write_fence.get(phys, 0) + 1
            fenced.append(phys)

    def _unfence(self, fenced):
        """Drop one fence per listed block (its dispatch's device work has
        landed). A quarantined block whose last fence drops is parked by
        :meth:`_park_free_block`."""
        for phys in fenced:
            n = self._write_fence.get(phys, 0) - 1
            if n > 0:
                self._write_fence[phys] = n
            else:
                self._write_fence.pop(phys, None)
                if phys in self._quarantine:
                    self._quarantine.discard(phys)
                    self._park_free_block(phys)
        if fenced:
            self._check_pool_invariants()

    def _check_pool_invariants(self):
        """Allocator audit (``PADDLE_TPU_POOL_CHECKS=1``): every block sits
        in exactly one of {free heap, LRU cached, live-referenced,
        quarantined}; a quarantined block is fenced and a free or cached
        one is not; a cached block is registered; refcounts equal table
        references; table rows mirror ``_slot_blocks`` with a -1 tail; the
        scratch block never circulates."""
        if not self._debug_pool:
            return
        free = set(self._free_blocks)
        cached = set(self._lru)
        quarantined = set(self._quarantine)
        live = [p for blocks in self._slot_blocks for p in blocks]
        live_set = set(live)
        assert len(free) == len(self._free_blocks), "free heap duplicates"
        pools = (free, cached, live_set, quarantined)
        for i, a in enumerate(pools):
            for bset in pools[i + 1:]:
                assert not (a & bset), "block in two pools"
        assert free | cached | live_set | quarantined == \
            set(range(self.n_blocks)), (
                f"pool leak: free({len(free)}) + cached({len(cached)}) + "
                f"live({len(live_set)}) + quarantined({len(quarantined)}) "
                f"!= n_blocks({self.n_blocks})")
        for phys in quarantined:
            assert self._write_fence.get(phys), \
                f"unfenced block {phys} stuck in quarantine"
        for phys in free | cached:
            assert not self._write_fence.get(phys), \
                f"fenced block {phys} in an allocatable pool"
        for phys in cached:
            assert phys in self._block_hash, \
                f"unregistered block {phys} in the cached LRU"
        refs = collections.Counter(live)
        for phys in range(self.n_blocks):
            assert self._block_ref[phys] == refs.get(phys, 0), (
                f"block {phys}: refcount {self._block_ref[phys]} != "
                f"{refs.get(phys, 0)} table references")
        for b in range(self.B):
            blocks = self._slot_blocks[b]
            row = self._tables[b]
            assert list(row[:len(blocks)]) == blocks, f"table row {b} drift"
            assert all(x == -1 for x in row[len(blocks):]), \
                f"table row {b} stale tail"

    # ------------------------------------------------------------------
    # the content-addressed store (enable_prefix_cache)
    # ------------------------------------------------------------------
    @staticmethod
    def _tenant_root(adapter_id=0):
        """The hash chain's root for a tenant: adapter id 0 (the base
        model) keeps ``_ROOT_HASH``; adapters are not ported."""
        if adapter_id:
            _unported("adapter tenants in the prefix cache", "A10")
        return _ROOT_HASH

    @staticmethod
    def _chain_hash(parent, tokens):
        """Rolling prefix hash of one full block: blake2b over the parent
        hash and the block's int32 token bytes, 16-byte digest (reference
        ``:2120-2127``, the same bytes)."""
        return hashlib.blake2b(
            parent + np.asarray(tokens, np.int32).tobytes(),
            digest_size=16).digest()

    def _register_block(self, phys, chain_hash, parent, tokens):
        """Publish a full private block's content identity. The first
        writer wins: a hash already in the store leaves ``phys``
        unregistered, to free normally."""
        if chain_hash in self._store or phys in self._block_hash:
            return
        self._store[chain_hash] = phys
        self._block_hash[phys] = chain_hash
        self._block_parent[phys] = parent
        self._block_tokens[phys] = np.asarray(tokens, np.int32).tobytes()
        self._children.setdefault(parent, []).append(phys)

    def _unregister(self, phys):
        h = self._block_hash.pop(phys, None)
        if h is None:
            return
        self._store.pop(h, None)
        parent = self._block_parent.pop(phys)
        kids = self._children.get(parent)
        if kids is not None:
            kids.remove(phys)
            if not kids:
                del self._children[parent]
        self._block_tokens.pop(phys, None)

    @staticmethod
    def _slot_token_range(slot, lo, hi):
        """Token ids at positions [lo, hi) of ``slot``'s committed stream
        (prompt, then generated)."""
        P = slot.prompt_len
        if hi <= P:
            return slot.req.prompt_ids[lo:hi]
        gen = np.asarray(slot.generated, np.int32)
        if lo >= P:
            return gen[lo - P:hi - P]
        return np.concatenate([slot.req.prompt_ids[lo:], gen[:hi - P]])

    def _register_upto(self, slot_idx, slot, upto_pos):
        """Register every newly full block of ``slot``'s committed stream
        [0, upto_pos), extending its chain. Hit blocks were registered by
        their first writer and are skipped through ``reg_blocks``."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        blocks = self._slot_blocks[slot_idx]
        n_full = min(upto_pos // bs, len(blocks))
        while slot.reg_blocks < n_full:
            i = slot.reg_blocks
            toks = self._slot_token_range(slot, i * bs, (i + 1) * bs)
            parent = slot.chain[i - 1] if i else self._tenant_root()
            h = self._chain_hash(parent, toks)
            slot.chain.append(h)
            self._register_block(blocks[i], h, parent, toks)
            slot.reg_blocks += 1

    def _probe_prefix(self, slot_idx, token_ids, chunk_granular=False):
        """Attach the longest cached prefix of ``token_ids`` to slot
        ``slot_idx`` by table writes and refcount bumps; the hit is capped
        at P - 1 tokens, so the last prompt position is always computed
        and admission has its logits. ``chunk_granular`` (legacy): the
        hit rounds down to whole chunks, since legacy windows scatter
        whole chunk spans and must never write a shared block. Otherwise
        a copy-on-write tail extends it to token granularity. Returns
        ``(hit tokens, chain hashes of the full-block hits)``."""
        P = len(token_ids)
        bs = self.block_size
        max_full = (P - 1) // bs
        if chunk_granular:
            max_full = ((P - 1) // self.chunk) * (self.chunk // bs)
        found, parent = [], self._tenant_root()
        for k in range(min(max_full, self._max_blocks)):
            h = self._chain_hash(parent, token_ids[k * bs:(k + 1) * bs])
            phys = self._store.get(h)
            if phys is None:
                break
            # claim it now. A registered block may sit in quarantine
            # (released while its writer's dispatch was in flight):
            # attaching it is safe, the write precedes any reader on the
            # stream, but it must leave quarantine or its unfence would
            # free a live block
            if self._block_ref[phys] == 0:
                self._lru.pop(phys, None)
                self._quarantine.discard(phys)
            self._block_ref[phys] += 1
            found.append((h, phys))
            parent = h
        if chunk_granular:
            per = self.chunk // bs
            keep = (len(found) // per) * per
            for _, phys in found[keep:]:
                self._release_block(phys)
            found = found[:keep]
        blocks = self._slot_blocks[slot_idx]
        chain = []
        for k, (h, phys) in enumerate(found):
            self._tables[slot_idx, k] = phys
            blocks.append(phys)
            chain.append(h)
        hit = len(found) * bs
        if not chunk_granular:
            hit += self._cow_tail(slot_idx, token_ids, hit, chain)
        self._check_pool_invariants()
        return hit, chain

    def prefix_chain_hashes(self, token_ids, adapter_id=0):
        """Chain hashes of the full blocks of ``token_ids`` (at most
        ``max_blocks``; the last token never counts): the router's
        affinity key, equal to the reference's bytes. Empty when the
        prefix cache is off."""
        if not self.prefix_cache:
            return []
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        bs = self.block_size
        parent, out = self._tenant_root(adapter_id), []
        for k in range(min((len(ids) - 1) // bs, self._max_blocks)):
            parent = self._chain_hash(parent, ids[k * bs:(k + 1) * bs])
            out.append(parent)
        return out

    def probe_prefix_len(self, token_ids, chain_hashes=None, adapter_id=0):
        """Read-only probe: how many leading tokens of ``token_ids`` the
        store could serve now, in full blocks (no COW, no refcounts, no
        table writes). 0 when the prefix cache is off."""
        if not self.prefix_cache:
            return 0
        if chain_hashes is None:
            chain_hashes = self.prefix_chain_hashes(token_ids, adapter_id)
        hit = 0
        for h in chain_hashes[:self._max_blocks]:
            if h not in self._store:
                break
            hit += self.block_size
        return hit

    def _cow_tail(self, slot_idx, token_ids, hit, chain):
        """Copy-on-write tail: if a cached full block continues the hit's
        chain and its leading tokens match the rest of the prompt, clone
        it into a fresh private block (the slot will append into it) and
        count the matched tokens as hit. Returns them (0: no match or the
        pool is dry)."""
        P = len(token_ids)
        bs = self.block_size
        cap = min(bs - 1, P - 1 - hit)
        if cap <= 0:
            return 0
        parent = chain[-1] if chain else self._tenant_root()
        rem = np.asarray(token_ids[hit:hit + cap], np.int32)
        best, best_t = None, 0
        for phys in self._children.get(parent, ()):
            cand = np.frombuffer(self._block_tokens[phys],
                                 np.int32)[:len(rem)]
            t = int(np.cumprod(cand == rem).sum())
            if t > best_t:
                best, best_t = phys, t
        if best is None or not self._alloc_blocks(slot_idx, 1):
            return 0
        self._cow_copy(best, self._slot_blocks[slot_idx][-1])
        self.stats["prefix_cow_blocks"] += 1
        return best_t

    def _cow_copy(self, src, dst):
        """Clone block ``src`` into ``dst`` in every layer's K and V pool,
        with a quantized pool's scale rows, bit for bit (COW never
        re-rounds). The copies go on the engine's stream now, so they read
        ``src`` before any later dispatch can overwrite it, even when
        allocating ``dst`` just evicted ``src``; nothing waits."""
        for pools in (self._k, self._v, self._k_scale, self._v_scale):
            for t in pools:
                if t is not None:
                    t[dst].copy_(t[src])

    def _ensure_blocks(self, slot_idx, upto_pos):
        """Blocks covering positions [0, upto_pos]. False = pool dry."""
        need = upto_pos // self.block_size + 1
        have = len(self._slot_blocks[slot_idx])
        return need <= have or self._alloc_blocks(slot_idx, need - have)

    def prefill_blocks_needed(self, prompt_len):
        """Pool blocks the prefill of a ``prompt_len``-token prompt covers.
        Legacy admission writes whole chunk windows (chunk-rounded, then
        block-quantized); the fused scheduler writes exact positions, so it
        needs the prompt's own blocks plus the one the first decode token
        grows into (position ``prompt_len``). A dense engine has no pool:
        0 (the reference's dense engine has no ``block_size`` to divide
        by and raises AttributeError here)."""
        if not self._paged:
            return 0
        if self.scheduler == "fused":
            return -(-(prompt_len + 1) // self.block_size)
        pad_end = min(-(-prompt_len // self.chunk) * self.chunk,
                      self.capacity)
        return -(-pad_end // self.block_size)

    def _release_slot_blocks(self, slot_idx):
        for phys in reversed(self._slot_blocks[slot_idx]):
            self._release_block(phys)
        self._slot_blocks[slot_idx] = []
        self._tables[slot_idx, :] = -1
        self._check_pool_invariants()

    def _free_slot(self, slot_idx):
        """Retire slot ``slot_idx``: a paged slot's blocks release; a dense
        slot's buffer rows are simply overwritten by the next admission."""
        if self._paged:
            self._release_slot_blocks(slot_idx)
        self.slots[slot_idx] = None

    def _preempt_newest(self, exclude=None, newer_than=None, retired=None):
        """Pool pressure: evict the most recently admitted slot (newer than
        ``newer_than``) back to the FRONT of the waiting queue. Returns the
        evicted slot index or None."""
        candidates = [b for b, s in enumerate(self.slots)
                      if s is not None and b != exclude
                      and (newer_than is None
                           or self._admit_order[b] > newer_than)]
        if not candidates:
            return None
        b = max(candidates, key=lambda i: self._admit_order[i])
        self._preempt_slot(b, retired=retired)
        return b

    def _retire_pool_edge(self, b, retired=None):
        """Retire slot ``b`` with finish_reason 'preempted_pool'."""
        slot = self.slots[b]
        out = RequestOutput(
            slot.req.request_id,
            self._finish_tokens(slot.req, slot.generated), True,
            "preempted_pool")
        self.finished_outputs[slot.req.request_id] = out
        if retired is not None:
            retired.append(out)
        self._free_slot(b)
        return out

    def _preempt_slot(self, b, retired=None):
        """Evict slot ``b`` to the front of the waiting queue, its
        committed tokens joined to the prompt (re-prefill reproduces the
        greedy state). A slot whose grown prompt no longer fits the pool
        at all retires 'preempted_pool' instead."""
        slot = self.slots[b]
        req = slot.req
        done = np.concatenate([req.prompt_ids,
                               np.asarray(slot.generated, np.int32)])
        if self.prefill_blocks_needed(len(done)) > self.n_blocks:
            self._retire_pool_edge(b, retired)
            return
        prefix = self._preempted_prefix.get(req.request_id, [])
        self._preempted_prefix[req.request_id] = \
            list(prefix) + list(slot.generated)
        self.waiting.appendleft(GenerationRequest(
            req.request_id, done,
            req.max_new_tokens - len(slot.generated),
            req.temperature, req.top_p, req.eos_token_id,
            readout_stride=req.readout_stride,
            adapter_id=req.adapter_id, kind=req.kind,
            spec_ewma=req.spec_ewma, export_kv=req.export_kv))
        self._free_slot(b)
        self.stats["preemptions"] += 1
        if self._rec() is not None:
            self._rec_preempted.append(req.request_id)

    def _finish_tokens(self, req, generated):
        """Full output stream including tokens committed before a
        preemption. Called once per terminal output, so it also drops the
        request's acceptance EWMA entry."""
        prefix = self._preempted_prefix.pop(req.request_id, [])
        self._spec_ewma.pop(req.request_id, None)
        return list(prefix) + list(generated)

    # ------------------------------------------------------------------
    # host <-> device copies that never block the host
    # ------------------------------------------------------------------
    def _upload(self, arr, dtype=None):
        """A copy of numpy ``arr`` on the engine's device. On the card it
        goes up from a fresh pinned buffer without blocking the host:
        PyTorch's pinned allocator hands that buffer to no one else until
        the copy has landed, so each dispatch owns its staging buffers and
        the host never rewrites one that a copy still reads."""
        t = torch.from_numpy(np.array(arr))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _download(self, t):
        """Enqueue ``t``'s copy into a fresh pinned host buffer, valid once
        the dispatch's event has completed."""
        if self.device.type != "cuda":
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _prefill_chunk(self, ids, table_row, off, last):
        """Legacy admission: run prompt window ``ids [1, chunk]`` at
        position ``off``: gather the slot's blocks up to the window's end,
        attend through the static cache (masked plain attention — never
        the flash kernel, whose top-left causal mask would be wrong here),
        scatter the window's K/V back into its blocks. Returns the logits
        of in-window row ``last``.

        Quantized pools gather DEQUANTIZED blocks (in the model's dtype)
        and scatter requantized ones: each written block is whole-window
        content, its rows past ``last`` (padding) zeroed before its fresh
        absmax scale (reference ``llm_engine.py:1594-1618``)."""
        bs, chunk = self.block_size, self.chunk
        end = off + chunk
        nblk = chunk // bs
        quant = self.kv_quant
        safe = self._upload(np.maximum(table_row[:end // bs], 0), torch.long)
        phys = self._upload(table_row[off // bs:end // bs], torch.long)

        def gather(pool, scales):
            if quant:
                blks = _kv_quant_gather(pool, scales, safe, quant,
                                        self._head_dim).to(self._dtype)
            else:
                blks = pool[safe]                     # [n, Hkv, bs, D]
            return blks.permute(0, 2, 1, 3).reshape(
                1, end, blks.shape[1], blks.shape[3])

        caches = [StaticKVCache(gather(k, ks), gather(v, vs))
                  for k, v, ks, vs in zip(self._k, self._v, self._k_scale,
                                          self._v_scale)]
        hidden, new_caches = self.model.llama(self._upload(ids),
                                              kv_caches=caches,
                                              position_offset=off)
        logits_row = self.model._logits(hidden[:, last:last + 1])[0, 0] \
            .float()
        dead = None
        if quant:
            # window rows past `last` are padding: zeroed before the scale
            ridx = torch.arange(chunk, device=self.device).view(nblk, bs)
            dead = (ridx > last)[:, None, :, None]

        def scatter(pool, scales, buf):
            rows = buf[0, off:end]                    # [chunk, Hkv, D]
            blks = rows.reshape(nblk, bs, rows.shape[1],
                                rows.shape[2]).transpose(1, 2)
            if quant:
                blks = blks.float().masked_fill(dead, 0.0)
                s_new = kv_block_scale(blks, quant, (2, 3))
                pool[phys] = kv_quantize(blks, s_new[..., None, None], quant)
                scales[phys] = s_new
            else:
                pool[phys] = blks

        for k, v, ks, vs, cc in zip(self._k, self._v, self._k_scale,
                                    self._v_scale, new_caches):
            scatter(k, ks, cc.k)
            scatter(v, vs, cc.v)
        return logits_row

    def _prefill_window(self, ids, slot_idx, win, last):
        """Legacy admission on a dense engine: run prompt window ``ids [1,
        chunk]`` at position ``win`` through a static cache over slot
        ``slot_idx``'s own buffer rows (masked plain attention; the
        window's K/V land in the buffers in place). Returns the logits of
        in-window row ``last``."""
        caches = [StaticKVCache(k[slot_idx:slot_idx + 1],
                                v[slot_idx:slot_idx + 1])
                  for k, v in zip(self._k, self._v)]
        hidden, _ = self.model.llama(self._upload(ids), kv_caches=caches,
                                     position_offset=win)
        return self.model._logits(hidden[:, last:last + 1])[0, 0].float()

    def _admit(self, slot_idx, req):
        """Legacy admission: chunked prefill of ``req`` into slot
        ``slot_idx``, from the prefix cache's chunk-granular hit on.
        Returns False when the pool cannot cover the prompt's chunk
        windows (the hit is rolled back); a dense engine always admits."""
        t0 = time.perf_counter()
        P = len(req.prompt_ids)
        hit, chain = 0, []
        if self.prefix_cache:
            hit, chain = self._probe_prefix(slot_idx, req.prompt_ids,
                                            chunk_granular=True)
        if self._paged:
            # prefill writes whole chunks: cover round_up(P, chunk), then
            # release the over-allocation down to the prompt's own blocks
            pad_end = self.prefill_blocks_needed(P) * self.block_size
            if not self._ensure_blocks(slot_idx, pad_end - 1):
                self._release_slot_blocks(slot_idx)
                return False
        self.stats["prefix_hit_tokens"] += hit
        # legacy admission prefills BEFORE the step dispatches: its spans
        # stamp the id the upcoming dispatch will take, so request time
        # still joins back to a StepRecord
        rec = self._rec()
        if hit and rec is not None:
            rec.req_event(req.request_id, "cached_prefix",
                          step_id=rec.next_step_id(), value=hit)
        padded = np.zeros((max(-(-P // self.chunk) * self.chunk,
                               self.chunk),), np.int32)
        padded[:P] = req.prompt_ids
        table_row = self._tables[slot_idx].copy() if self._paged else None
        off = hit
        logits_row = None
        while off < P:
            take = min(self.chunk, P - off)
            if self._paged:
                # windows stay block-aligned: off is a multiple of chunk
                # and capacity % chunk == 0
                logits_row = self._prefill_chunk(
                    padded[off:off + self.chunk][None], table_row, off,
                    take - 1)
            else:
                # a window that would cross the buffer's end slides BACK,
                # as the reference's clamped dynamic slice does: positions
                # [win, off) are recomputed with the same K/V and the new
                # tokens land at [off, off + take)
                win = min(off, self.capacity - self.chunk)
                logits_row = self._prefill_window(
                    padded[win:win + self.chunk][None], slot_idx, win,
                    off + take - 1 - win)
            off += take
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += take
            if rec is not None:
                rec.req_event(req.request_id, "prefill",
                              step_id=rec.next_step_id(), value=take)
        if self._paged:
            keep = P // self.block_size + 1
            blocks = self._slot_blocks[slot_idx]
            while len(blocks) > keep:
                phys = blocks.pop()
                self._tables[slot_idx, len(blocks)] = -1
                self._release_block(phys)
        self._admit_order[slot_idx] = self._admit_seq
        self._admit_seq += 1
        self._logits[slot_idx] = logits_row
        # fill_, not item assignment: assigning a Python number copies it
        # from pageable host memory, a blocking copy
        self._lens[slot_idx].fill_(P)
        self._set_token_history(slot_idx, req.prompt_ids)
        slot = self.slots[slot_idx] = _Slot(req, P)
        slot.chain, slot.reg_blocks = chain, len(chain)
        # the whole prompt is prefilled: publish its full blocks
        self._register_upto(slot_idx, slot, P)
        self._check_pool_invariants()
        self.stats["admit_time_s"] += time.perf_counter() - t0
        return True

    def _admit_fused(self, slot_idx, req):
        """Fused admission: slot ASSIGNMENT, plus the prefix cache's probe
        (hit blocks attach by table writes, a COW tail costs one block's
        clone); the device lens and ``prefill_pos`` start at the hit. No
        prefill dispatch and no other block allocation: both happen chunk
        by chunk inside the step scheduler, so admission never stalls the
        running decodes."""
        t0 = time.perf_counter()
        hit, chain = 0, []
        if self.prefix_cache:
            hit, chain = self._probe_prefix(slot_idx, req.prompt_ids)
        self._lens[slot_idx].fill_(hit)
        # the WHOLE prompt, host-known even over a prefix hit
        self._set_token_history(slot_idx, req.prompt_ids)
        slot = self.slots[slot_idx] = _Slot(req, len(req.prompt_ids),
                                            prefill_pos=hit)
        slot.chain, slot.reg_blocks = chain, len(chain)
        if hit:
            self.stats["prefix_hit_tokens"] += hit
            rec = self._rec()
            if rec is not None:
                rec.req_event(req.request_id, "cached_prefix",
                              step_id=rec.next_step_id(), value=hit)
        self._admit_order[slot_idx] = self._admit_seq
        self._admit_seq += 1
        self.stats["admit_time_s"] += time.perf_counter() - t0

    def _set_token_history(self, slot_idx, prompt_ids):
        """A speculative engine's draft history for an admitted slot
        (reference ``llm_engine.py:3284-3289``, ``:3337-3343``): the
        prompt, zero-padded to ``capacity`` (what a draft reads past the
        length), in one copy through a pinned staging buffer. No-op
        without speculation."""
        if self._tokens is None:
            return
        row = np.zeros((self.capacity,), np.int32)
        row[:len(prompt_ids)] = prompt_ids
        self._tokens[slot_idx] = self._upload(row)

    def _admit_waiting(self):
        fused = self.scheduler == "fused"
        for b in range(self.B):
            if not self.waiting:
                break
            if self.slots[b] is None:
                req = self.waiting[0]
                room = self.capacity - len(req.prompt_ids) - \
                    self.speculative_k
                if req.max_new_tokens > room:
                    warnings.warn(
                        f"request {req.request_id}: capping max_new_tokens "
                        f"{req.max_new_tokens} -> {room} (engine capacity "
                        f"{self.capacity})", RuntimeWarning, stacklevel=3)
                    req.max_new_tokens = room
                if fused and self._paged:
                    need = self.prefill_blocks_needed(len(req.prompt_ids))
                    if need > self.n_blocks:
                        # can never ramp in: leave it at the head;
                        # step_begin raises the too-small-pool error
                        break
                    # progress guarantee (the fused-ramp livelock fix): no
                    # new ramp while the pool cannot cover it AND the
                    # outstanding ramp demand of resident ramping slots —
                    # two ramps over a pool barely larger than one prompt
                    # would otherwise trade blocks through the preempt
                    # ladder forever. The resident ramp can always finish
                    # alone, and its retirement re-opens admission.
                    ramp_deficit = sum(
                        max(self.prefill_blocks_needed(s.prompt_len)
                            - len(self._slot_blocks[i]), 0)
                        for i, s in enumerate(self.slots)
                        if s is not None and s.ramping)
                    if ramp_deficit and \
                            need + ramp_deficit > self._n_allocatable():
                        break
                self.waiting.popleft()
                if fused:
                    self._admit_fused(b, req)
                elif not self._admit(b, req):
                    # pool dry: requeue and wait for a retirement
                    self.waiting.appendleft(req)
                    break

    # ------------------------------------------------------------------
    # the engine loop
    # ------------------------------------------------------------------
    def step(self):
        """Admit waiting requests into free slots, run ONE step for all
        active slots, retire finished requests. Returns the list of
        RequestOutput finished by this step."""
        pending = self.step_begin()
        if pending is None:
            return []
        return self.step_finish(pending)

    def _dispatched(self, toks, was_active, pool_done, sched, fenced, kind,
                    counts=None, offered=None, verify=None):
        """Close a dispatch: enqueue its token/activity readback (and a
        speculative dispatch's counts and, from the fused programs, offered
        widths) into pinned host memory and record its event. Nothing
        waits here."""
        toks, was_active = self._download(toks), self._download(was_active)
        if counts is not None:
            counts = self._download(counts)
        if offered is not None:
            offered = self._download(offered)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight += 1
        return PendingStep(toks, was_active, list(self.slots), pool_done,
                           sched=sched, fenced=fenced, event=event,
                           kind=kind, counts=counts, offered=offered,
                           verify=verify)

    def _caches(self, tables, lens, q_lens=None):
        """One cache per layer over the engine's buffers for a decode step
        (``q_lens`` None) or a mixed step: a dense engine's
        :class:`SlotKVCache` or :class:`ChunkKVCache`, a paged one's
        :class:`PagedKVCache` (with the scale arrays when quantized)."""
        if not self._paged:
            if q_lens is None:
                return [SlotKVCache(k, v, lens)
                        for k, v in zip(self._k, self._v)]
            return [ChunkKVCache(k, v, lens, q_lens)
                    for k, v in zip(self._k, self._v)]
        return [PagedKVCache(k, v, tables, lens, q_lens, ks, vs,
                             self.kv_quant)
                for k, v, ks, vs in zip(self._k, self._v, self._k_scale,
                                        self._v_scale)]

    def _decode(self, active, eos_ids, budgets, n_iter):
        """``n_iter`` greedy decode iterations for every slot, all on the
        device (``horizon`` on the scan path, the trimmed stride on a
        multi-step dispatch): sample from the carried logits, one-token
        model step through the slot buffers or the paged pools, carry
        logits and lens. Inactive slots decode token 0 and keep their
        carried logits (a slot deactivated by the pool budget clamp
        samples from them next step); a row after every slot stopped comes
        out all-inactive."""
        tables = self._upload(self._tables) if self._paged else None
        act = self._upload(active)
        eos = self._upload(eos_ids)
        buds = self._upload(budgets)
        logits, lens = self._logits, self._lens
        emitted = torch.zeros_like(lens)
        toks, was_active = [], []
        model = self.model
        for _ in range(n_iter):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(act, nxt, torch.zeros_like(nxt))
            caches = self._caches(tables, lens)
            hidden, _ = model.llama(nxt[:, None], kv_caches=caches,
                                    position_offset=lens)
            new_logits = model._logits(hidden)[:, 0].float()
            logits = torch.where(act[:, None], new_logits, logits)
            lens = torch.where(act, lens + 1, lens)
            finished = act & (nxt == eos)
            emitted = emitted + act.to(torch.int32)
            toks.append(nxt)
            was_active.append(act)
            act = act & ~finished & (lens < self.capacity - 1) & \
                (emitted < buds)
        self._logits, self._lens = logits, lens
        return torch.stack(toks), torch.stack(was_active)

    def _spec_scan(self, active, eos_ids, budgets, n_win):
        """The legacy scheduler's speculative scan (reference ``spec_step``,
        ``llm_engine.py:1212-1268``): ``n_win`` full-width verify windows
        for every slot over the dense slot buffers. Each window drafts
        ``k - 1`` tokens from the history, commits the argmax of the
        carried logits (0 where inactive), runs ONE model call over
        ``[committed, drafts]`` through :class:`SlotKVCache` at the slots'
        lengths, accepts by the coupled rule at width ``k`` where active,
        carries the logits of the last accepted row, grows the lengths by
        the counts and writes the whole window into every row's history
        (inactive rows too, at their clamped lengths, as the reference
        does); eos counts only inside the committed prefix. The next
        window's activity also needs ``lens < capacity - k``. The window
        writes of a slot past that margin (a pipelined over-dispatch)
        clamp into its own buffer row's end, as JAX's dynamic updates
        clamp. The host runs ``n_win`` windows, its bound on the
        reference's ``horizon``; windows after every slot stopped come out
        inactive. Returns ``[n_win, B, k]`` windows and ``[n_win, B]``
        counts and activity."""
        Kw, cap = self.speculative_k, self.capacity
        act = self._upload(active)
        eos = self._upload(eos_ids)
        buds = self._upload(budgets)
        logits, lens, tbuf = self._logits, self._lens, self._tokens
        emitted = torch.zeros_like(lens)
        kidx = torch.arange(Kw, device=self.device)[None]
        full = torch.full_like(lens, Kw)
        model = self.model
        toks, cnts, was_active = [], [], []
        for _ in range(n_win):
            draft = _lookup_draft(tbuf, lens, Kw - 1, self.lookup_ngram)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(act, nxt, torch.zeros_like(nxt))
            window = torch.cat([nxt[:, None], draft], dim=1)   # [B, Kw]
            hidden, _ = model.llama(window, kv_caches=self._caches(None, lens),
                                    position_offset=lens)
            logits_win = model._logits(hidden).float()         # [B, Kw, V]
            counts, new_logits = _verify_window(
                logits_win, draft, torch.where(act, full, 0), act)
            logits = torch.where(act[:, None], new_logits, logits)
            new_lens = lens + counts
            _write_window(tbuf, window, lens)
            emitted = emitted + counts
            eos_hit = ((kidx < counts[:, None]) &
                       (window == eos[:, None])).any(dim=1)
            toks.append(window)
            cnts.append(counts)
            was_active.append(act)
            act = act & ~eos_hit & (new_lens < cap - Kw) & (emitted < buds)
            lens = new_lens
        self._logits, self._lens = logits, lens
        return torch.stack(toks), torch.stack(cnts), torch.stack(was_active)

    def _fused_step(self, ids, q_lens, is_decode, active):
        """ONE mixed prefill+decode dispatch: slot b processes rows
        ``[0, q_lens[b])`` of ``ids`` — a prefill chunk (host-provided
        prompt rows) or one decode token (row 0, sampled on the device from
        the carried logits). Every slot's rows sit at its own absolute
        positions (``lens``); padding rows write nothing. The LM head runs
        over each slot's last valid row only; inactive slots keep their
        carried logits. Returns ``[1, B]`` token and activity rows.

        A speculative engine's decode slot (reference ``fused_step``'s
        verify branch, ``llm_engine.py:1405-1500``) has a VERIFY grant: its
        ``q_lens[b] = 1 + drafts`` rows are its committed token and then
        the prompt-lookup drafts, padded into the chunk; the token history
        takes the window of decode slots only, the head also runs over
        ``hidden[:, :Kw]`` for the coupled rule, and a verify slot's lens
        grow by its committed count. Returns the ``[1, B, Kw]`` windows and
        the ``[1, B]`` activity, counts and offered widths."""
        Kw = self.speculative_k
        spec = Kw > 1
        tables = self._upload(self._tables) if self._paged else None
        ids_t = self._upload(ids)
        ql = self._upload(q_lens)
        is_dec = self._upload(is_decode)
        act = self._upload(active)
        logits, lens = self._logits, self._lens
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        # capacity guard for pipelined over-dispatch: a window that would
        # cross the buffer end deactivates on the device
        act = act & (lens + ql <= self.capacity)
        dec = act & is_dec
        if spec:
            # a verify window must fit the token-history write: a slot
            # clamped out goes fully inactive (its rows must not write)
            dec = dec & (lens + Kw <= self.capacity)
            act = act & (~is_dec | dec)
        nxt = torch.where(dec, nxt, torch.zeros_like(nxt))
        q_eff = torch.where(act, ql, torch.zeros_like(ql))
        if not spec:
            ids_t[:, 0] = torch.where(dec, nxt, ids_t[:, 0])
        else:
            draft = _lookup_draft(self._tokens, lens, Kw - 1,
                                  self.lookup_ngram)
            window = torch.cat([nxt[:, None], draft], dim=1)   # [B, Kw]
            ids_t[:, :Kw] = torch.where(dec[:, None], window, ids_t[:, :Kw])
            _write_window(self._tokens, window, lens, dec)
        caches = self._caches(tables, lens, q_eff)
        hidden, _ = self.model.llama(ids_t, kv_caches=caches,
                                     position_offset=lens)
        last = (q_eff - 1).clamp(min=0).long()
        rows = hidden.gather(1, last[:, None, None].expand(
            -1, 1, hidden.shape[-1]))                  # [B, 1, H]
        new_logits = self.model._logits(rows)[:, 0].float()
        if not spec:
            self._logits = torch.where(act[:, None], new_logits, logits)
            self._lens = lens + q_eff
            return nxt[None], dec[None]
        # verify slots need every window row's logits: the head over [B,
        # Kw, H], bounded by the window, never the whole chunk
        logits_win = self.model._logits(hidden[:, :Kw]).float()
        counts, spec_logits = _verify_window(logits_win, draft, q_eff, dec)
        new_logits = torch.where(dec[:, None], spec_logits, new_logits)
        self._logits = torch.where(act[:, None], new_logits, logits)
        # rejected drafts roll back here: a verify slot grows by its
        # committed count; the KV rows written past it are unreferenced
        # and the next window overwrites them
        self._lens = lens + torch.where(dec, counts, q_eff)
        return window[None], dec[None], counts[None], q_eff[None]

    def _multi_spec(self, n_win, active, eos_ids, budgets, spec_qs, row_caps):
        """The all-decode speculative dispatch (reference
        ``make_multi_spec``, ``llm_engine.py:1270-1371``): ``n_win`` verify
        windows for every slot, each through the append form over ``[B,
        Kw]`` ids (paged: the paged-append kernel; dense:
        :class:`ChunkKVCache`) with the coupled rule, lens and token
        history carried. A window's width is the slot's granted
        ``spec_qs`` shrunk to its covered rows ``row_caps`` and capacity;
        eos, budget and the capacity margin deactivate a slot on the
        device. The reference's loop stops once no slot is active; here the
        host runs ``n_win`` windows, its own bound, and windows after every
        slot stopped come out inactive, with zero counts. Returns ``[n_win, B, Kw]``
        windows and ``[n_win, B]`` activity, counts and offered widths."""
        Kw, cap = self.speculative_k, self.capacity
        tables = self._upload(self._tables) if self._paged else None
        act = self._upload(active)
        eos = self._upload(eos_ids)
        buds = self._upload(budgets)
        qs = self._upload(spec_qs)
        caps = self._upload(row_caps).clamp(max=cap)
        logits, lens, tbuf = self._logits, self._lens, self._tokens
        emitted = torch.zeros_like(lens)
        kidx = torch.arange(Kw, device=self.device)[None]
        model = self.model
        toks, cnts, was_active, offered = [], [], [], []
        for _ in range(n_win):
            # pipelined over-dispatch guard: a slot an in-flight dispatch
            # grew to the capacity margin stops before its window could
            # cross the buffer (or the token history's end)
            act = act & (lens + Kw <= cap)
            draft = _lookup_draft(tbuf, lens, Kw - 1, self.lookup_ngram)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(act, nxt, torch.zeros_like(nxt))
            window = torch.cat([nxt[:, None], draft], dim=1)
            # the granted 1 + k drafts, shrunk to the covered-block and
            # capacity row budget (pool pressure narrows windows first)
            q_eff = torch.minimum((caps - lens).clamp(min=0), qs)
            q_eff = torch.where(act, q_eff, torch.zeros_like(q_eff))
            act = act & (q_eff >= 1)
            q_eff = torch.where(act, q_eff, torch.zeros_like(q_eff))
            caches = self._caches(tables, lens, q_eff)
            hidden, _ = model.llama(window, kv_caches=caches,
                                    position_offset=lens)
            logits_win = model._logits(hidden).float()         # [B, Kw, V]
            counts, new_logits = _verify_window(logits_win, draft, q_eff,
                                                act)
            logits = torch.where(act[:, None], new_logits, logits)
            _write_window(tbuf, window, lens, act)
            new_lens = lens + counts
            toks.append(window)
            cnts.append(counts)
            was_active.append(act)
            offered.append(q_eff)
            emitted = emitted + counts
            eos_hit = ((kidx < counts[:, None]) &
                       (window == eos[:, None])).any(dim=1)
            act = act & ~eos_hit & (new_lens < cap - Kw) & (emitted < buds)
            lens = new_lens
        self._logits, self._lens = logits, lens
        return (torch.stack(toks), torch.stack(was_active),
                torch.stack(cnts), torch.stack(offered))

    def _rec(self):
        """The attached FlightRecorder when it is recording, else None:
        the one-attribute-check gate every hook goes through."""
        r = self.flight_recorder
        return r if (r is not None and r.enabled) else None

    def _record_dispatch(self, pending, kind, grants, scheduled, budget,
                         dispatch_s, readout_stride=1):
        """Emit this dispatch's StepRecord (recorder attached and armed by
        step_begin) and stamp ``pending`` with its step id (reference
        ``llm_engine.py:3443-3502``). The admit/schedule splits come from
        the engine's own stats deltas anchored at step_begin entry. The
        host KV tier (A8(g)) and adapters (A10) are not ported: their
        fields carry what a reference engine without them records."""
        rec, ctx = self._rec(), self._rec_ctx
        if rec is None or ctx is None:
            return
        t0, admit0, hits0 = ctx
        wall = time.perf_counter() - t0
        admit_s = self.stats["admit_time_s"] - admit0
        paged = self._paged
        preempted = tuple(self._rec_preempted) + tuple(
            o.request_id for o in pending.pool_done)
        pending.step_id = rec.begin_step(
            scheduler=self.scheduler, kind=kind, grants=grants,
            tokens_scheduled=scheduled, token_budget=budget,
            queue_depth=len(self.waiting),
            free_blocks=len(self._free_blocks) if paged else None,
            total_blocks=self.n_blocks if paged else None,
            pipeline_inflight=self._inflight,
            preemptions=preempted, admit_s=admit_s,
            schedule_s=max(wall - admit_s - dispatch_s, 0.0),
            dispatch_s=dispatch_s, t_begin=t0,
            prefix_hit_tokens=(self.stats["prefix_hit_tokens"] - hits0
                               if self.prefix_cache else None),
            cached_blocks=len(self._lru) if self.prefix_cache else None,
            readout_stride=readout_stride,
            kv_pool_bytes=self._kv_nbytes if paged else None,
            kv_cache_dtype=(self.kv_quant
                            or str(self._dtype).replace("torch.", ""))
            if paged else None,
            kv_swap_in_bytes=0 if paged else None,
            kv_swap_out_bytes=0 if paged else None,
            kv_host_spill_blocks=0 if paged else None,
            kv_ship_in_bytes=0 if paged else None,
            kv_ship_out_bytes=0 if paged else None,
            adapter_slots=(), adapter_swaps=0)
        self._rec_ctx = None

    def _slot_sampling_arrays(self):
        """Per-slot eos ids (-1: none) and remaining token budgets of an
        all-decode dispatch, plain or speculative."""
        eos_ids = np.array([(s.req.eos_token_id if s and
                             s.req.eos_token_id is not None else -1)
                            for s in self.slots], np.int32)
        budgets = np.array([(s.req.max_new_tokens - len(s.generated))
                            if s else 0 for s in self.slots], np.int32)
        return eos_ids, budgets

    def _effective_stride(self):
        """The readout stride of the NEXT all-decode dispatch (reference
        ``llm_engine.py:1778-1789``): the engine's ``readout_stride``
        capped by every active slot's pin (a latency-tier request pinning
        1 drags the whole batch to per-step readout while it is resident),
        and ``horizon`` off the fused stride path."""
        if self.scheduler != "fused" or self.readout_stride <= 1:
            return self.horizon
        pins = [s.req.readout_stride for s in self.slots
                if s is not None and s.req.readout_stride is not None]
        return max(1, min([self.readout_stride] + pins))

    # ------------------------------------------------------------------
    # acceptance-adaptive verify-k (reference ``llm_engine.py:1742-1776``)
    # ------------------------------------------------------------------
    def _spec_k_for(self, slot):
        """Draft count of ``slot``'s next verify grant: its acceptance EWMA
        scaled into ``[1, speculative_k - 1]`` (the full window until the
        first readout teaches otherwise). A low-acceptance request keeps
        proposing ONE draft, never zero, so its EWMA can recover."""
        ewma = slot.req.spec_ewma
        if ewma is None:
            ewma = self._spec_ewma.get(slot.req.request_id, 1.0)
        kd = self.speculative_k - 1
        return max(1, min(kd, int(round(ewma * kd + 0.25))))

    def _update_spec_ewma(self, slot, proposed, accepted):
        """Fold one readout's accepted/proposed drafts into the request's
        EWMA (the request's field and the rid-keyed mirror)."""
        if proposed <= 0:
            return
        rate = accepted / proposed
        prev = slot.req.spec_ewma
        if prev is None:
            prev = self._spec_ewma.get(slot.req.request_id, rate)
        ewma = (1.0 - _SPEC_EWMA_ALPHA) * prev + _SPEC_EWMA_ALPHA * rate
        slot.req.spec_ewma = ewma
        self._spec_ewma[slot.req.request_id] = ewma

    def spec_ewma_for(self, request_id):
        """The persisted draft-acceptance EWMA of ``request_id`` (None:
        never speculated), what a failover forwards as ``spec_ewma``."""
        return self._spec_ewma.get(request_id)

    def step_begin(self):
        """Admit waiting requests into free slots and DISPATCH one step for
        the active slots without waiting on the device. Returns a
        :class:`PendingStep` for :meth:`step_finish`, or None when there is
        nothing to run. Up to :meth:`max_pipeline_depth` steps may be in
        flight."""
        fi = self.fault_injector
        if fi is not None:
            fi.on_step_begin(self)
        depth = self.max_pipeline_depth()
        if self._inflight >= depth:
            raise RuntimeError(
                f"{self.scheduler} {self.cache_impl} engine cannot pipeline "
                f"step_begin() calls deeper than {depth} (step_finish the "
                f"outstanding PendingStep first; see max_pipeline_depth())")
        with torch.no_grad():
            return self._step_begin()

    def _step_begin(self):
        if self._rec() is not None:
            # wall-split anchors for this step's record: entry time, the
            # admit-stat baseline (scheduling = wall - admit - dispatch)
            # and the prefix-hit baseline (the record carries the delta)
            self._rec_ctx = (time.perf_counter(),
                             self.stats["admit_time_s"],
                             self.stats["prefix_hit_tokens"])
            self._rec_preempted = []
        self._admit_waiting()
        if not any(s is not None for s in self.slots):
            if self.waiting and self._paged:
                req = self.waiting[0]
                P = len(req.prompt_ids)
                need = self.prefill_blocks_needed(P)
                if need > self.n_blocks:
                    raise PoolCapacityError(
                        f"request {req.request_id}: prefilling its "
                        f"{P}-token prompt needs {need} KV blocks but the "
                        f"pool has {self.n_blocks} total (kv_pool_blocks "
                        f"too small)")
            return None
        pool_done = []
        fused = self.scheduler == "fused"
        if fused and any(s is not None and s.ramping for s in self.slots):
            # a slot is ramping in: ONE mixed dispatch covers its prefill
            # chunk AND every decode slot's token
            return self._begin_mixed_step(pool_done)
        if fused and self.speculative_k > 1:
            # speculative ALL-DECODE: verify windows for every slot, up to
            # the stride of them in one dispatch
            return self._begin_spec_decode(pool_done)
        # ALL-DECODE: with readout_stride > 1 the fused scheduler runs up
        # to `stride` decode iterations as one dispatch, its block
        # coverage and write fence pre-granted for the whole stride;
        # legacy engines keep stride == horizon
        stride = self._effective_stride()
        pool_budget = {}
        # block coverage for the stride's growth; pool pressure first grabs
        # whatever blocks remain (partial coverage + a budget clamp), then
        # evicts newer slots, and retires only at the pool edge
        order = sorted((b for b, s in enumerate(self.slots) if s is not None),
                       key=lambda i: self._admit_order[i]) \
            if self._paged else ()
        for b in order:
            slot = self.slots[b]
            if slot is None:
                continue  # evicted below while ensuring an older slot
            # the scheduled length counts in-flight growth (fused
            # pipelining); legacy engines run depth 1, where it is the
            # current length
            cur = slot.sched_len()
            last_pos = min(cur + stride - 1, self.capacity - 1)
            while not self._ensure_blocks(b, last_pos):
                avail = self._n_allocatable()
                if avail:
                    self._alloc_blocks(b, avail)
                covered = len(self._slot_blocks[b]) * self.block_size
                if covered > cur:
                    pool_budget[b] = covered - cur
                    break
                victim = self._preempt_newest(
                    exclude=b, newer_than=self._admit_order[b],
                    retired=pool_done)
                if victim is None:
                    # this slot is the newest: self-preempt while older
                    # slots run, retire at the pool edge when it is alone
                    if any(s is not None and i != b
                           for i, s in enumerate(self.slots)):
                        self._preempt_slot(b, retired=pool_done)
                        break
                    self._retire_pool_edge(b, pool_done)
                    break
        active = np.array([s is not None for s in self.slots])
        if not active.any():
            if pool_done:
                pending = PendingStep(None, None, list(self.slots),
                                      pool_done)
                # no dispatch, but preemptions or retirements happened:
                # record the drain so the causal chain has no hole
                self._record_dispatch(pending, "drain", (), 0,
                                      self.B * self.horizon, 0.0)
                return pending
            return None
        eos_ids, budgets = self._slot_sampling_arrays()
        for b, cap_left in pool_budget.items():
            budgets[b] = min(budgets[b], cap_left)
        # the in-flight write fence (fused): every block this dispatch may
        # write, from each slot's committed length through its scheduled
        # stride
        fenced = []
        if fused and self._paged:
            for b, slot in enumerate(self.slots):
                if slot is not None:
                    lo = slot.prefill_pos + len(slot.generated)
                    hi = min(slot.sched_len() + stride - 1,
                             self.capacity - 1)
                    self._fence_blocks(b, lo, hi, fenced)
        # multi-step all-decode: one dispatch of up to `stride` iterations
        # read back by one sync. The reference's loop exits on the device
        # once no slot is active; here the host trims it to what it
        # already knows, the largest remaining budget (a row past it is
        # inactive for every slot), and never reads the device to decide.
        # Pinned latency-tier steps (stride 1), horizon and legacy engines
        # keep the scan path
        use_multi = self.readout_stride > 1 and stride > 1
        # the legacy speculative scan (a fused engine's returned above):
        # `horizon` full verify windows, trimmed by the same host bound,
        # since every live window commits a token a slot
        spec = self.speculative_k > 1
        n_iter = stride
        if use_multi or spec:
            n_iter = max(1, min(stride, int(budgets[active].max())))
        t0 = time.perf_counter()
        counts = verify = None
        if spec:
            toks, counts, was_active = self._spec_scan(active, eos_ids,
                                                       budgets, n_iter)
            # full-width windows: the grant IS what each window proposes
            verify = {int(b): self.speculative_k - 1
                      for b in np.nonzero(active)[0]}
        else:
            toks, was_active = self._decode(active, eos_ids, budgets, n_iter)
        if use_multi:
            self.stats["multi_steps"] += 1
        sched = {}
        if fused:
            # host lens mirror: a surviving slot grows exactly `stride`
            # tokens per dispatch (every early deactivation, eos, budget
            # or capacity, also retires the slot at readout)
            for b, slot in enumerate(self.slots):
                if slot is not None:
                    slot.inflight += stride
                    sched[b] = stride
        kind = "spec" if spec else "decode"
        pending = self._dispatched(toks, was_active, pool_done, sched,
                                   fenced, kind, counts, verify=verify)
        dt = time.perf_counter() - t0
        pending.t_dispatch = t0
        self.stats["dispatch_time_s"] += dt
        self.stats["decode_time_s"] += dt
        if self._rec() is not None:
            # ONE decode grant per slot covering the whole stride (spec:
            # stride verify windows of k tokens each)
            per_slot = stride * self.speculative_k
            grants = tuple((b, s.req.request_id, "decode", per_slot)
                           for b, s in enumerate(self.slots)
                           if s is not None and active[b])
            self._record_dispatch(pending, kind, grants,
                                  sum(g[3] for g in grants),
                                  self.B * per_slot, dt,
                                  readout_stride=per_slot)
        return pending

    # ------------------------------------------------------------------
    # fused scheduler: the speculative all-decode dispatch
    # ------------------------------------------------------------------
    def _begin_spec_decode(self, pool_done):
        """ALL-DECODE dispatch of a speculative engine (reference
        ``llm_engine.py:3905-4036``): every slot gets a VERIFY grant of 1
        committed token plus its adaptive draft count a window, run as up
        to ``stride`` windows in one dispatch. Pool pressure first shrinks
        a paged slot's windows to the rows its blocks cover
        (``row_caps``); only a slot that cannot write its committed token
        walks the preemption ladder. The host mirrors the worst case
        (every window fully accepted) until the readout pays it back."""
        stride = self._effective_stride()
        Kw = self.speculative_k
        spec_qs = np.zeros((self.B,), np.int32)
        row_caps = np.full((self.B,), self.capacity, np.int32)
        order = sorted((b for b, s in enumerate(self.slots) if s is not None),
                       key=lambda i: self._admit_order[i])
        for b in order:
            slot = self.slots[b]
            if slot is None:
                continue  # evicted while covering an older slot
            cur = slot.sched_len()
            if cur >= self.capacity:
                continue  # pipelined overshoot; readout retires it
            kd = self._spec_k_for(slot)
            if self._paged:
                want_hi = min(cur + stride * (1 + kd) - 1, self.capacity - 1)
                if not self._ensure_blocks(b, want_hi):
                    avail = self._n_allocatable()
                    if avail:
                        self._alloc_blocks(b, avail)
                    covered = len(self._slot_blocks[b]) * self.block_size
                    if covered <= cur:
                        # not even the committed token: the ordinary
                        # coverage ladder (preempt newer, park, retire)
                        if not self._ensure_pos_covered(b, cur, pool_done):
                            continue
                        covered = len(self._slot_blocks[b]) * \
                            self.block_size
                    row_caps[b] = min(int(row_caps[b]), covered)
            spec_qs[b] = 1 + kd
        active = np.array([spec_qs[b] > 0 and self.slots[b] is not None
                           for b in range(self.B)])
        if not active.any():
            if pool_done:
                pending = PendingStep(None, None, list(self.slots),
                                      pool_done)
                self._record_dispatch(pending, "drain", (), 0,
                                      self.B * Kw * stride, 0.0)
                return pending
            return None
        eos_ids, budgets = self._slot_sampling_arrays()
        # the write fence over every position the windows may write: the
        # committed length through the stride of full windows
        fenced = []
        if self._paged:
            for b in np.nonzero(active)[0]:
                slot = self.slots[b]
                lo = slot.prefill_pos + len(slot.generated)
                hi = min(slot.sched_len() + stride * int(spec_qs[b]) - 1,
                         self.capacity - 1)
                self._fence_blocks(int(b), lo, hi, fenced)
        # every window commits at least one token a live slot, so after
        # the largest remaining budget of windows every slot has stopped:
        # the host's own bound on the reference's in-graph exit
        n_win = max(1, min(stride, int(budgets[active].max())))
        t0 = time.perf_counter()
        toks, was_active, counts, offered = self._multi_spec(
            n_win, active, eos_ids, budgets, spec_qs, row_caps)
        self.stats["fused_steps"] += 1
        if stride > 1:
            self.stats["multi_steps"] += 1
        sched, verify = {}, {}
        for b in np.nonzero(active)[0]:
            slot = self.slots[b]
            if slot is not None:
                n = stride * int(spec_qs[b])
                slot.inflight += n
                sched[int(b)] = n
                verify[int(b)] = int(spec_qs[b]) - 1
        pending = self._dispatched(toks, was_active, pool_done, sched,
                                   fenced, "spec", counts, offered, verify)
        dt = time.perf_counter() - t0
        pending.t_dispatch = t0
        self.stats["dispatch_time_s"] += dt
        self.stats["decode_time_s"] += dt
        if self._rec() is not None:
            grants = tuple(
                (int(b), self.slots[b].req.request_id, "verify",
                 stride * int(spec_qs[b]))
                for b in np.nonzero(active)[0] if self.slots[b] is not None)
            self._record_dispatch(pending, "spec", grants,
                                  sum(g[3] for g in grants),
                                  self.B * Kw * stride, dt,
                                  readout_stride=Kw * stride)
        return pending

    # ------------------------------------------------------------------
    # fused scheduler: the mixed step
    # ------------------------------------------------------------------
    def _ensure_pos_covered(self, b, pos, retired):
        """Cover decode position ``pos`` for slot ``b``, preempting NEWER
        slots under pool pressure. Returns False when slot ``b`` itself had
        to be preempted (parked) or retired at the pool edge."""
        while not self._ensure_blocks(b, pos):
            victim = self._preempt_newest(
                exclude=b, newer_than=self._admit_order[b], retired=retired)
            if victim is not None:
                continue
            if any(s is not None and i != b
                   for i, s in enumerate(self.slots)):
                self._preempt_slot(b, retired=retired)
            else:
                # sole active slot at the pool edge: parking it would
                # readmit into the same dry pool and spin
                self._retire_pool_edge(b, retired)
            return False
        return True

    def _schedule_mixed(self, pool_done):
        """One token-budget scheduling pass: per slot, either one decode
        token (always granted — the budget bounds prefill interference, not
        decode progress) or a prefill chunk grant of up to ``min(chunk,
        remaining prompt, budget left)`` tokens, walked in admission order
        so older requests ramp first. Paged blocks allocate here; a ramping
        slot that cannot cover its grant shrinks it to the blocks it could
        grab and otherwise waits for a retirement. A dense engine grants
        without that ladder: its slot buffers hold every position.

        A speculative engine gives a decode slot a VERIFY grant instead
        (reference ``llm_engine.py:4075-4149``): the committed token
        always, plus its acceptance-adaptive draft count, which the
        remaining budget and the blocks the pool could cover shrink
        first. Returns the grants and ``spec_ks`` (drafts a slot; None
        without speculation)."""
        B, S = self.B, self.chunk
        spec = self.speculative_k > 1
        ids = np.zeros((B, S), np.int32)
        q_lens = np.zeros((B,), np.int32)
        spec_ks = np.zeros((B,), np.int32) if spec else None
        is_dec = np.zeros((B,), bool)
        active = np.zeros((B,), bool)
        sched = {}
        budget = self.max_step_tokens
        order = sorted((b for b, s in enumerate(self.slots)
                        if s is not None),
                       key=lambda i: self._admit_order[i])
        for b in order:                      # decode slots first
            slot = self.slots[b]
            if slot is None or slot.ramping:
                continue
            cur = slot.sched_len()
            if cur >= self.capacity:
                continue  # pipelined overshoot; readout retires it
            if self._paged and \
                    not self._ensure_pos_covered(b, cur, pool_done):
                continue
            q = 1
            if spec:
                kd = min(self._spec_k_for(slot), max(budget - 1, 0))
                if self._paged and kd > 0 and \
                        not self._ensure_blocks(b, cur + kd):
                    avail = self._n_allocatable()
                    if avail:
                        self._alloc_blocks(b, avail)
                    covered = len(self._slot_blocks[b]) * self.block_size
                    kd = max(0, min(kd, covered - cur - 1))
                spec_ks[b] = kd
                q = 1 + kd
            q_lens[b] = q
            is_dec[b] = True
            active[b] = True
            sched[b] = q
            budget -= q
        first_ramp = True
        for b in order:                      # then prefill grants
            slot = self.slots[b]
            if slot is None or not slot.ramping:
                continue
            # progress guarantee: even when decode tokens alone exhaust the
            # budget, the OLDEST ramping slot still gets one token
            grant_cap = budget if budget > 0 else (1 if first_ramp else 0)
            if grant_cap <= 0:
                continue
            pos = slot.prefill_pos
            take = min(S, slot.prompt_len - pos, grant_cap)
            if self._paged and take > 0 and \
                    not self._ensure_blocks(b, pos + take - 1):
                avail = self._n_allocatable()
                if avail:
                    self._alloc_blocks(b, avail)
                covered = len(self._slot_blocks[b]) * self.block_size
                take = min(take, covered - pos)
            if take <= 0:
                continue
            # the guaranteed token is spent only on a grant that landed
            first_ramp = False
            ids[b, :take] = slot.req.prompt_ids[pos:pos + take]
            q_lens[b] = take
            active[b] = True
            budget -= take
        return ids, q_lens, is_dec, active, sched, spec_ks

    def _begin_mixed_step(self, pool_done):
        """Schedule and DISPATCH one fused mixed step (>= 1 slot is
        ramping)."""
        for _ in range(self.B + 1):
            ids, q_lens, is_dec, active, sched, spec_ks = \
                self._schedule_mixed(pool_done)
            if active.any():
                break
            # nothing schedulable: every assigned slot is ramping into a
            # dry pool — park the newest (frees blocks for an older ramp)
            if not self._paged or \
                    self._preempt_newest(retired=pool_done) is None:
                break
        if not active.any():
            if pool_done:
                pending = PendingStep(None, None, list(self.slots),
                                      pool_done)
                self._record_dispatch(pending, "drain", (), 0,
                                      self.max_step_tokens, 0.0)
                return pending
            return None
        # write fence over this dispatch's spans: the decode token per
        # decode slot, the granted chunk span per ramping slot
        fenced = []
        for b in np.nonzero(active)[0] if self._paged else ():
            slot = self.slots[b]
            lo = slot.prefill_pos + len(slot.generated)
            hi = slot.sched_len() + int(q_lens[b]) - 1 if is_dec[b] \
                else slot.prefill_pos + int(q_lens[b]) - 1
            self._fence_blocks(int(b), lo, min(hi, self.capacity - 1),
                               fenced)
        spec = spec_ks is not None
        t0 = time.perf_counter()
        counts = offered = None
        if spec:
            toks, was_active, counts, offered = self._fused_step(
                ids, q_lens, is_dec, active)
        else:
            toks, was_active = self._fused_step(ids, q_lens, is_dec, active)
        self.stats["fused_steps"] += 1
        # host mirrors of the scheduled growth (dispatch-time, so the next
        # step — possibly dispatched before this one's readout — schedules
        # from the post-step state)
        verify = {}
        for b in np.nonzero(active)[0]:
            slot = self.slots[b]
            if is_dec[b]:
                slot.inflight += int(q_lens[b])
                if spec:
                    verify[int(b)] = int(spec_ks[b])
            else:
                slot.prefill_pos += int(q_lens[b])
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens"] += int(q_lens[b])
                # the blocks this grant fills are prompt content: publish
                # them now, so a request admitted next step hits them (its
                # reads are dispatched after this grant's writes)
                self._register_upto(int(b), slot, slot.prefill_pos)
        pending = self._dispatched(toks, was_active, pool_done, sched,
                                   fenced, "mixed", counts, offered, verify)
        dt = time.perf_counter() - t0
        pending.t_dispatch = t0
        self.stats["dispatch_time_s"] += dt
        self.stats["decode_time_s"] += dt
        rec = self._rec()
        if rec is not None:
            grants = tuple(
                (int(b), self.slots[b].req.request_id,
                 ("verify" if spec else "decode") if is_dec[b]
                 else "prefill", int(q_lens[b]))
                for b in np.nonzero(active)[0] if self.slots[b] is not None)
            self._record_dispatch(pending, "mixed", grants,
                                  sum(g[3] for g in grants),
                                  self.max_step_tokens, dt,
                                  readout_stride=self.speculative_k)
            for _, rid, gkind, n in grants:
                if gkind == "prefill":
                    rec.req_event(rid, "prefill",
                                  step_id=pending.step_id, value=n)
        return pending

    def step_finish(self, pending):
        """Wait for ``pending``'s own event (never for younger dispatches),
        attribute its tokens to the slots captured at dispatch, retire
        finished requests. Returns the RequestOutputs finished by this
        step. Tokens of a slot whose occupant changed since dispatch are
        dropped: they were decoded for the old occupant's state."""
        fi = self.fault_injector
        if fi is not None:
            fi.on_step_finish(self)
        rec = self._rec()
        sid = pending.step_id
        if pending.toks is None:
            if rec is not None and sid is not None:
                rec.finish_step(sid, 0.0, 0.0, tuple(
                    o.request_id for o in pending.pool_done))
            return list(pending.pool_done)
        self._inflight -= 1
        # pay the dispatch's scheduled decode growth back off the host lens
        # mirror (fused scheduler; {} otherwise)
        for b, n in pending.sched.items():
            slot = pending.slots[b]
            if slot is not None and self.slots[b] is slot:
                slot.inflight = max(0, slot.inflight - n)
        spec = pending.spec
        Ks = self.speculative_k
        t0 = time.perf_counter()
        if pending.event is not None:
            pending.event.synchronize()
        if spec:
            toks3 = pending.toks.numpy()               # [windows, B, Ks]
            counts_np = pending.counts.numpy()         # [windows, B]
            wa_np = pending.was_active.numpy()         # [windows, B]
            # [windows, B] from the fused programs; the legacy scan's
            # windows are never clamped, so it reads back none
            offered_np = pending.offered.numpy() \
                if pending.offered is not None else None
            Kh, B_, _ = toks3.shape
            # windows flattened into the [rows, B] stream the readout
            # walks: row i of a window is live iff i < its count, so the
            # stream has gaps the walk SKIPS instead of stopping at
            toks_np = toks3.transpose(0, 2, 1).reshape(Kh * Ks, B_)
            act_np = ((np.arange(Ks)[None, :, None] < counts_np[:, None, :])
                      & wa_np[:, None, :]).reshape(Kh * Ks, B_)
        else:
            toks_np = pending.toks.numpy()             # [K, B]
            act_np = pending.was_active.numpy()        # [K, B]
        dt = time.perf_counter() - t0
        self.stats["host_sync_time_s"] += dt
        self.stats["decode_time_s"] += dt
        self.stats["steps"] += 1
        # the dispatch's device work (every KV write included) has landed,
        # so its write fences drop BEFORE the readout can free blocks
        if pending.fenced:
            self._unfence(pending.fenced)
        # batched-readout stamp amortization (reference :4365-4395): a
        # k-row readout drains k device iterations in this one sync, so
        # each row's emit stamp is backdated by the iterations still ahead
        # of it, the dispatch-to-sync window divided over the rows the
        # device ran with any slot active; a verify window is ONE such
        # boundary (its rows commit together)
        if spec:
            row_boundary = np.arange(toks_np.shape[0]) // Ks
            n_exec = int(wa_np.any(axis=1).sum())
        else:
            row_boundary = np.arange(toks_np.shape[0])
            n_exec = int(act_np.any(axis=1).sum())
        per_row = 0.0
        if toks_np.shape[0] > 1 and pending.t_dispatch is not None \
                and n_exec > 1:
            per_row = max(time.perf_counter() - pending.t_dispatch,
                          0.0) / n_exec
        now_pc = time.perf_counter()
        t0 = time.perf_counter()
        done = list(pending.pool_done)
        spec_acc_total = spec_rej_total = 0
        for b, slot in enumerate(pending.slots):
            if slot is None or self.slots[b] is not slot:
                continue
            finish_reason = None
            n_read = 0
            for k in range(toks_np.shape[0]):
                if not act_np[k, b]:
                    if spec:
                        # a verify window's rejected tail: later windows
                        # may still hold live tokens
                        continue
                    break  # deactivated on the device at an earlier row
                tok = int(toks_np[k, b])
                slot.generated.append(tok)
                n_read += 1
                self.stats["tokens_generated"] += 1
                self.emit_backdate_s = \
                    max(n_exec - 1 - int(row_boundary[k]), 0) * per_row
                if rec is not None and sid is not None:
                    # the token-to-step join, stamped at the token's
                    # amortized device step boundary
                    rec.on_token(slot.req.request_id, sid,
                                 t=now_pc - self.emit_backdate_s)
                if self.stream_callback is not None:
                    self.stream_callback(slot.req.request_id, tok)
                    if self.slots[b] is not slot:
                        # the callback cancelled the request: keep the
                        # 'cancelled' output it recorded
                        break
                if slot.req.eos_token_id is not None and \
                        tok == slot.req.eos_token_id:
                    finish_reason = "eos"
                elif len(slot.generated) >= slot.req.max_new_tokens:
                    finish_reason = "length"
                elif slot.prompt_len + len(slot.generated) >= \
                        self.capacity - self.speculative_k:
                    finish_reason = "capacity"
                if finish_reason:
                    break
            if spec and n_read > 0:
                # drafts that landed in the output (row 0 of a window is
                # the committed token, not a draft), against the drafts
                # the device OFFERED: the fused programs' in-graph clamps
                # can shrink a window below its grant, the legacy scan
                # never does, so there the grant is exact
                n_committed = sum(1 for k in range(toks_np.shape[0])
                                  if act_np[k, b] and k % Ks == 0)
                accepted = max(n_read - n_committed, 0)
                self.stats["draft_tokens_accepted"] += accepted
                if offered_np is not None:
                    proposed = int(np.maximum(offered_np[:, b] - 1, 0)
                                   [wa_np[:, b]].sum())
                else:
                    proposed = int(wa_np[:, b].sum()) * \
                        pending.verify.get(b, Ks - 1)
                self.stats["spec_proposed_tokens"] += proposed
                self.stats["spec_accepted_tokens"] += accepted
                spec_acc_total += accepted
                spec_rej_total += max(proposed - accepted, 0)
                if self.slots[b] is slot:
                    # a stream callback may have cancelled the request
                    # mid-readout, dropping its EWMA entry: updating it
                    # now would resurrect a finished rid's state
                    self._update_spec_ewma(slot, proposed, accepted)
            if self.slots[b] is not slot:
                continue
            if n_read:
                # decode-filled blocks register too: a follow-up prompt
                # carrying this stream hits them
                self._register_upto(b, slot,
                                    slot.prefill_pos + len(slot.generated))
            if finish_reason:
                out = RequestOutput(
                    slot.req.request_id,
                    self._finish_tokens(slot.req, slot.generated), True,
                    finish_reason)
                self.finished_outputs[slot.req.request_id] = out
                done.append(out)
                self._free_slot(b)
        if self._paged and pending.verify:
            # BLOCK-TABLE ROLLBACK (reference :4504-4521): blocks granted
            # to drafts the device rejected are orphaned; release them,
            # no copy. The keep line is the slot's scheduled length, which
            # still counts younger dispatches' growth, and a block a
            # younger dispatch fences goes to quarantine, not the heap
            bs = self.block_size
            for b in pending.verify:
                slot = pending.slots[b]
                if slot is None or self.slots[b] is not slot:
                    continue  # retired or preempted: blocks already freed
                keep = slot.sched_len() // bs + 1
                blocks = self._slot_blocks[b]
                while len(blocks) > keep:
                    phys = blocks.pop()
                    self._tables[b, len(blocks)] = -1
                    self._release_block(phys)
            self._check_pool_invariants()
        self.emit_backdate_s = 0.0
        d_emit = time.perf_counter() - t0
        self.stats["emit_time_s"] += d_emit
        if rec is not None and sid is not None:
            rec.finish_step(sid, dt, d_emit,
                            tuple(out.request_id for out in done),
                            spec_accepted=spec_acc_total,
                            spec_rejected=spec_rej_total)
        return done

    def generate(self, prompts, **sampling):
        """Drain-mode convenience: submit all prompts, run steps until every
        request finishes, return outputs in submission order."""
        rids = [self.add_request(p, **sampling) for p in prompts]
        while self.has_unfinished():
            self.step()
        return [self.finished_outputs.pop(r) for r in rids]
