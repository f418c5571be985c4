"""Multi-step decode A/B (counterpart: ``bench.py:112-186``,
``_serve_multi_step_ab``): the same prompts served through two
fused-scheduler engines behind :class:`AsyncLLMServer`,
``readout_stride=stride`` against ``readout_stride=1``, with each arm's
host-tax split read off a :class:`FlightRecorder`'s StepRecords.

Per arm: ``tokens_per_sec``, ``host_round_trips`` (StepRecords: one
dispatch and one readout each), ``multi_steps``, ``host_sync_share``
(readout waits over the wall), ``dispatch_share``, ``rtt_share`` (``rtt_s``
× round trips over the wall), ``host_tax_s`` and ``host_tax_ms_per_token``
(sync + dispatch seconds, absolute and per token: the arms serve the same
work, so this is the fair cross-arm comparison) and ``pipeline_depth``.
Greedy streams must be token-exact across arms (asserted, as the
reference asserts them), unless the caller takes the streams to hold
each arm to its own check: on the card in bf16 the stride moves
admissions, so a token can take a mixed step in one arm and an
all-decode step in the other, whose different products round apart at
near-ties.

Used by ``chip_smoke.py`` phase (d-vii) on the card and by
``tests/test_torch_multi_step.py`` on the CPU::

    from paddle_tpu_torch.tools.multi_step_ab import serve_multi_step_ab
    ab = serve_multi_step_ab(model, prompts, new_tokens=64, B=8, cap=576,
                             stride=8)
"""
from __future__ import annotations

import contextlib
import time

from ..inference import LLMEngine
from ..profiler import FlightRecorder
from ..serving import AsyncLLMServer

__all__ = ["serve_multi_step_ab", "serve_stride_arm"]


def serve_stride_arm(model, prompts, new_tokens, B, cap, stride,
                     rtt_s=0.0, chunk_size=256, pipeline_depth=2,
                     timeout=1800, device=None, engine_kw=None, watch=None):
    """One arm: a fused engine at ``readout_stride=stride`` (warmed by one
    2-token request, then its stats reset), the prompts through a server
    with a flight recorder. ``engine_kw`` adds engine arguments (a paged
    pool, for one); ``watch(eng)``, when given, returns a context manager
    entered around the timed serve. Returns ``(arm, token lists)``."""
    eng = LLMEngine(model, max_batch=B, max_seq_len=cap,
                    chunk_size=chunk_size, scheduler="fused",
                    readout_stride=stride, device=device,
                    **(engine_kw or {}))
    eng.generate([prompts[0]], max_new_tokens=2)  # warm the programs
    eng.reset_stats()
    rec = FlightRecorder()
    srv = AsyncLLMServer(eng, max_queue_size=len(prompts) + 1,
                         flight_recorder=rec,
                         pipeline_depth=pipeline_depth)
    with (watch(eng) if watch is not None else contextlib.nullcontext()):
        srv.start()
        t0 = time.perf_counter()
        hs = [srv.submit(p, max_new_tokens=new_tokens) for p in prompts]
        outs = [h.result(timeout=timeout) for h in hs]
        wall = time.perf_counter() - t0
        srv.stop()
    toks = sum(len(o.token_ids) for o in outs)
    recs = rec.records()
    sync_s = sum(r.sync_s for r in recs)
    disp_s = sum(r.dispatch_s for r in recs)
    arm = {
        "readout_stride": int(stride),
        "tokens_per_sec": round(toks / wall, 1),
        "host_round_trips": len(recs),
        "multi_steps": int(eng.stats["multi_steps"]),
        "host_sync_share": round(sync_s / wall, 4),
        "dispatch_share": round(disp_s / wall, 4),
        "rtt_share": round(rtt_s * len(recs) / wall, 4),
        "host_tax_s": round(sync_s + disp_s, 4),
        "host_tax_ms_per_token": round(
            (sync_s + disp_s) / max(toks, 1) * 1e3, 4),
        "pipeline_depth": srv.pipeline_depth,
    }
    return arm, [list(o.token_ids) for o in outs]


def serve_multi_step_ab(model, prompts, new_tokens, B, cap, stride,
                        rtt_s=0.0, chunk_size=256, pipeline_depth=2,
                        timeout=1800, device=None, watch=None, streams=None):
    """The reference's A/B: the stride-1 arm ("off"), then the stride arm
    ("on"), each through :func:`serve_stride_arm` (``watch(arm, eng)``,
    when given, wraps each arm's serve). Asserts token parity, unless
    ``streams`` (a dict) is given: then it takes each arm's token lists
    and ``token_parity`` reports what the caller checks. Returns both
    arms with ``multi_step_speedup``."""
    arms, got = {}, {}
    for arm, s in (("off", 1), ("on", int(stride))):
        arms[arm], got[arm] = serve_stride_arm(
            model, prompts, new_tokens, B, cap, s, rtt_s=rtt_s,
            chunk_size=chunk_size, pipeline_depth=pipeline_depth,
            timeout=timeout, device=device,
            watch=(lambda eng, arm=arm: watch(arm, eng))
            if watch is not None else None)
    token_parity = got["on"] == got["off"]
    if streams is None:
        assert token_parity, "multi-step decode changed a greedy stream"
    else:
        streams.update(got)
    return {
        "multi_step_speedup": round(
            arms["on"]["tokens_per_sec"]
            / max(arms["off"]["tokens_per_sec"], 1e-9), 3),
        "readout_stride": int(stride),
        "token_parity": token_parity,
        "on": arms["on"], "off": arms["off"],
    }
