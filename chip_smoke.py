#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch on one NVIDIA H100.

Run from the repository root: ``python3 chip_smoke.py``. It drives the
port's main path on the card and fails (nonzero exit, no result line) if
any phase fails, if CUDA is absent, or if the package is not beside it.
``python3 chip_smoke.py --profile-quant ROOT`` runs only the quantized KV
arms' step windows of phase (d''), over the package under ROOT
(profile_quant_main).

Phases:
  (a) build   — compile every kernel of the path from paddle_tpu_torch/csrc
                with nvcc for sm_90a, all nvcc processes at once, and print
                B1's, B5's, the paged libraries' and B8's ptxas lines
                (registers, barriers, spills); B5 may neither spill nor have
                a warpgroup.arrive injected, the paged libraries (B2, B3 and
                both forms of B4) and B8 may not spill;
  (b) parity  — each kernel against its plain PyTorch version on the card,
                bf16, at the main path's shapes plus edge cases (B1 at
                D 128 and 64, GQA and one kv head, S 2048, 1000 and 17; B5
                at D 128 and 64, causal and full, GQA, one kv head under 32
                q heads, dropout, S 2048, 1000 and 512; B2 and B3 at the
                serving shapes with MHA and G 4, and over long contexts
                (MB 128, lens up to 8,191) where their walks split, B3
                also at a step of speculative verify windows (S 6, q_lens
                2-6 after 63, 64, 65 and ~4,000 positions, a window
                across a block edge, rows parked in the scratch block);
                both
                AdamW kernels with bf16 and float32 grads, bit for bit;
                B8, the int4 GEMM: its launch geometry held against the
                kernel's constants at rows 1-128 on five shapes, then rows
                1, 5, 8, 16, 32, 48, 64, 127 and 128 on each with bf16 and
                float32 x against the plain version, run twice for the
                same bits;
                B4's decode and append forms on int8 and int4 pools with
                payload and scales bit for bit outside the scratch block, a
                dirty block whose stale rows must not reach its scale, an
                idle slot whose blocks must stay byte for byte, the same
                bits on two runs, and 32 sequences of 8,192 at G 4);
  (c) forward — LlamaForCausalLM at Llama-2-7B widths (32 layers, bf16,
                seeded random weights) on [2, 2048] ids: finite logits,
                one flash launch per layer;
  (d) serving — LLMEngine(cache_impl="paged", scheduler="legacy") answers
                12 greedy requests (prompts of 100-1500 tokens, 64 new
                tokens each, 8 slots): every request finishes, one decode
                launch per layer per decode step, and every token is the
                argmax of a no-cache forward over its prefix wherever that
                forward's top-1/top-2 margin exceeds 0.05 (bf16 near-ties
                excused), and no step_begin makes a synchronizing CUDA
                call (CUDA's sync debug mode watches each one, here and
                in (d'));
  (d') fused  — the same 12 requests through LLMEngine(scheduler="fused"),
                driven with step_begin/step_finish pipelined at depth 2:
                every request finishes with its 64 tokens, one append launch
                per layer per mixed step and one decode launch per layer per
                all-decode step, the same greedy check, every block free at
                the end; tokens/s, step times, TTFT, the real-row share of
                the mixed steps, agreement with phase (d), and for each
                mixed step_begin dispatched behind another mixed step its
                host ms, the step's device ms and whether the step in
                flight still ran when it returned (information);
  (d'') quant — the same 12 requests served through AsyncLLMServer
                (default depth) over LLMEngine(scheduler="fused") in three
                arms at equal pool bytes, sized as the reference's
                llama_serve_kv_quant: bf16 at half the full block demand
                (128 blocks), int8 and int4 at that budget over their bytes
                per block (capped at the full 256). Every request finishes
                with its 64 tokens; a quantized arm launches only its B4
                decode and append kernels (one per layer per step of each
                kind), the bf16 arm only B2 and B3, and no arm reaches a
                plain version; no step_begin on the server's thread makes a
                synchronizing call; the pool invariants hold and the server
                is healthy at the end; the bf16 arm passes the greedy check.
                Per arm: tokens/s, preemptions, mean resident slots,
                effective blocks, TTFT p50/p90, stage shares, median step
                ms, launches, each quantized arm's drift against bf16, and
                each quantized arm's windows of mixed and all-decode steps,
                untraced and traced (device ms per step by kernel class,
                B4-append's write pass and attention apart; information);
  (d-iii) weight-only — the reference's llama_serve rung (Llama-2-7B
                widths with ff 11264, 32 layers, seeded random bf16
                weights): the same 12 requests through AsyncLLMServer over
                the fused engine with a bf16 KV pool at the full demand
                (256 blocks), in three arms: bf16 weights, a copy quantized
                to weight-only int8 on the card, then the model quantized
                to int4 in place. Gates: 225 swaps per quantization; every
                request finishes with its 64 tokens; the int4 arm launches
                B8 224 times (7 per layer) in every all-decode step and
                never in a mixed step, the other arms never; no plain
                version (paged or B8) runs; only B2/B3 attend; no
                synchronizing call in step_begin; pool invariants and
                server health hold; each arm's tokens equal a no-cache
                forward of its own model where the top-2 margin exceeds
                the arm's margin (the int4 arm's widened by the logit gap
                between B8 and the split-nibble route, measured first); in
                four traced decode steps the int4 arm calls B8 exactly 224
                times a step and the others never, and the trace holds one
                B8 kernel function and no more B8 kernels than calls (the
                gap: records the tracer dropped). Per arm: tokens/s,
                step ms, weight bytes, drift against bf16, and the traced
                steps' device ms by class (information); then (d-iv)'s
                generate at the static cache with the int4 model: B8 once
                per projection it takes a decode step, none in the
                prefill, the greedy check under the int4 arm's margin;
  (d-iv) generate — LlamaForCausalLM.generate, greedy, B 8, prompt 512,
                128 new tokens (the reference's llama_decode and
                llama_paged_decode rungs): the smoke's 32-layer model
                through the static cache (gates: one B1 launch per layer in
                the prefill, no paged kernel, no plain version, no
                synchronizing call, every token the no-cache argmax where
                the top-2 margin exceeds 0.05; with an eos id a row emits,
                at most one read a decode window and each row the free
                run's tokens up to its eos), then the paged rung's model (3
                layers, 8 kv heads, block 64): B2 once a layer a one-token
                step, the same greedy check, then the same with
                use_paged_attention off (no B2, the plain decode once a
                layer a step). Per arm the rungs' two-length differential
                (decode tokens/s and ms a token at 128 against 16 new
                tokens, prefill tokens/s) and drift against the static
                cache and the kernel (information);
  (d-v) prefix_cache — the llama_serve_prefix_cache rung's traffic on the
                32-layer model: 16 requests (a shared 256-token system
                prompt before tails of 64-127 tokens, 64 new tokens each;
                and all-unique prompts of the same lengths) through
                AsyncLLMServer over the fused engine (8 slots, chunk 256,
                block 64, capacity 512), cache on and off, the shared
                prompts also under the legacy scheduler and over an int8
                pool, with PADDLE_TPU_POOL_CHECKS=1. Gates: each stream
                equals its cache-off reference (served step by step, each
                token's margin read from the engine's logits) up to where
                that margin is at most 0.05; hits on every shared cache-on
                arm and none elsewhere; the pool audit; the serving arms'
                launch, plain-call and sync gates. Per arm: tokens/s, hit
                rate, hit tokens, COW and evicted blocks, TTFT p50, the
                unique arms' overhead (information);
  (d-vi) dense_serving — the dense engine (the reference's default): the
                32-layer model's 12 requests over a dense fused engine, then
                the llama_serve_fused rung (7B widths, ff 11264, 3 layers;
                16 requests of 256-511 tokens, 64 new) over dense fused,
                dense legacy and paged fused engines; no kernel and no plain
                version in a dense arm, the sync and greedy gates;
  (d-vii) serve_rung — the llama_serve rung (the same model and requests;
                LLMEngine(model, max_batch=8, max_seq_len=576,
                chunk_size=256, horizon=64), dense legacy) through
                AsyncLLMServer in the rung's passes: plain, then the flight
                recorder, supervision (RestartPolicy, step_timeout_s 300),
                the metrics store and trace contexts each on against off,
                medians of three alternating passes; the recorder's chrome
                trace (to a temporary directory), p99 tail and snapshot; the
                multi-step A/B (tools/multi_step_ab.py: dense fused engines
                at readout_stride 8 against 1); two traced stride-8 steps;
                then the 32-layer model's 12 requests over paged fused
                engines at readout_stride 8 against 1. Every serve runs
                under CUDA's sync debug mode: no synchronizing call in a
                step_begin or between steps, none in a step_finish beyond
                its readout. Gates: every request finishes with its 64
                tokens, every pass equals the plain pass; for each stride
                pair (dense rung, 32-layer paged) one wave of 8 requests
                through engines at stride 1 and 8 is token-exact, the
                served arms both pass the greedy check (so they agree up
                to bf16 near-ties: the stride moves admissions, and a
                token may take a mixed step in one arm and an all-decode
                step in the other), multi-step dispatches and fewer round
                trips in the stride arm; each StepRecord's readout_stride
                matches its dispatch, no kernel or counted plain version in
                a dense arm, B2 once a layer for each decode iteration of
                the 32-layer arms (B3 once a layer a mixed step), the server
                healthy, the greedy check on the plain pass. Per pass
                tokens/s, the four overheads, TTFT and
                e2e p50, the p99 tail causes, the A/B's host-tax split, the
                traced steps' idle share (information);
  (d-viii) spec_rung — the llama_serve_spec rung (the same model; 16
                repetition-heavy prompts, a 24-token random base tiled to
                256-383 tokens, 64 new) through AsyncLLMServer over dense
                fused engines at speculative_k=6, readout_stride=4 against
                speculative_k=1, at B 8 and at B 1 (3 requests), then the
                B 8 pair over paged bf16 engines (block 64). Every serve
                under CUDA's sync debug mode. Gates: every request finishes
                with its 64 tokens, the greedy check on every arm, one wave
                of 8 requests spec-on against spec-off token-exact (dense
                and paged; a parting only at a near-tie, reported with its
                step and margin), proposals in the spec arms, multi-step
                dispatches, spec StepRecords at readout_stride 6 x 4 with
                at most 4 windows, no kernel and no counted plain version
                in a dense arm, B3 once a layer for each verify window and
                mixed step of the paged spec arm and never B2 there, B2
                once a layer a decode iteration in the paged control arm.
                Per arm tokens/s, acceptance, accepted per step, windows
                per dispatch, rtt_share, TTFT and e2e p50, and
                speculation_speedup at B 8 and B 1; two traced all-decode
                dispatches of each dense engine: device busy, idle share,
                events a window against a decode iteration (information);
  (d-ix) legacy_spec — the reference's default speculation, the legacy
                scheduler's scan: (d-viii)'s model and prompts through
                AsyncLLMServer over LLMEngine(model, max_batch=8,
                max_seq_len=576, chunk_size=256, horizon=4,
                speculative_k=6) against speculative_k=1, at B 8 and at
                B 1 (3 requests), then one spec arm at B 8 over the model
                quantized in place to weight-only int4. Gates: every
                request finishes with its 64 tokens, the greedy check on
                every arm (the int4 arm's margin widened by the logit gap
                between B8 and the split-nibble route), one wave of 8
                requests spec-on against spec-off token-exact up to a
                reported near-tie, proposals and accepted drafts in the
                spec arms, spec StepRecords at readout_stride 6 x 4 with at
                most 4 windows, the sync gates on every dispatch, no kernel
                and no counted plain version in a bf16 arm, and in the int4
                arm B8 once for each quantized projection of every verify
                window, every call at 8 x 6 = 48 rows, never its plain
                version. Per arm tokens/s, acceptance, accepted per step,
                windows per dispatch, TTFT and e2e p50, speculation_speedup
                at B 8 and B 1, and the legacy spec arm against (d-viii)'s
                fused one at B 8 (information);
  (d-x) kv_tier — the llama_serve_kv_tier rung (bench.py:1341-1451 at its
                defaults): its 3-layer model (7B widths, ff 11264, MHA,
                bf16, seed 0, rope table 512) and 16 requests of 249-263
                tokens (one of two shared 153-token system prompts in
                alternation, then a unique tail; 64 new each) through
                AsyncLLMServer over the rung's engine (8 slots, chunk 256,
                block 64, capacity 512, paged, fused, prefix cache on,
                warmed with one 3-token request, then reset and
                reset_stats) in five arms: floor (64 blocks, tier off), off
                (32 blocks), on (32 blocks, kv_host_swap,
                kv_host_spill_bytes 256 MiB), int8 at 64 blocks with the
                tier off and at 32 with it on. Gates: every request
                finishes with its 64 tokens; the off arm preempts and the
                on arm re-prefills fewer tokens (prefill tokens beyond the
                floor arm's); swap-outs, restores and saved tokens in the
                on arms; every arm ends with every block free or cached,
                the swap store empty, the pool invariants and a healthy
                server; the on arms' streams equal their floor's up to a
                reported near-tie; the greedy check on the bf16 arms; no
                synchronizing call in step_begin; B3 once a layer a mixed
                step and B2 once a layer an all-decode step (B4 in the
                int8 arms), never a plain version; a swap-out and a
                restore of 8 blocks timed alone, from and into pinned
                memory, restoring the same bits. Per arm tokens/s, TTFT
                p50, the swap stall share, swap, spill and promote counts
                and bytes (information);
  (d-xi) cluster — the llama_serve_cluster rung (bench.py:1870-2020 at its
                defaults): its 3-layer model (7B widths, ff 11264, MHA,
                bf16, seed 0, rope table 512), one copy per replica, and 32
                requests (one of two tenants' 256-token system prompts
                before a 64-127-token tail; 64 new each) through
                ReplicaRouter over AsyncLLMServer replicas of the rung's
                engine (8 slots, chunk 256, horizon 64, block 64, capacity
                512, paged, fused, prefix cache on, each warmed with one
                3-token request): a seed wave of one request per tenant,
                waited for, then the other 30 at once with their tenant as
                routing_key. Arms: single (1 replica, affinity; run twice,
                single_2 for the spread), cluster (2,
                affinity), random (2, random placement), failover (2,
                affinity, resume_inflight; replica 0's watchdog at 3 s and a
                non-interruptible 10 s wedge at its first step that finds a
                timed request mid-stream there). Gates: every request finishes
                with its 64 tokens; the other arms' streams equal the single
                arm's up to a reported near-tie; every arm's tokens, the
                failover's resumed requests counted apart too, pass the
                greedy check; each resumed stream starts with what its
                caller had consumed (the wedged request's first token); the
                single arms' step_begins make no synchronizing call (the
                sync debug mode is process-wide, so only with one replica);
                affinity placements and both
                replicas placed in the cluster arm, whose hit rate beats the
                random arm's; in the failover arm replica 0 reads hung,
                evictions and resumptions, no request lost; each arm's B3
                launches equal its replicas' mixed steps and its B2 launches
                their decode iterations, once a layer, and no plain version
                runs; the router stops with nothing outstanding. Per arm the
                aggregate and per-replica tokens/s, hit rates, placements,
                wall time, the host's microseconds a launch before and after
                the arms, and the failover's timings (information). The
                two replicas share the card and its default stream;
  (d-xii) disagg — the llama_serve_disagg rung (bench.py:1487-1670 at its
                defaults): its 3-layer model (7B widths, ff 11264, MHA,
                bf16, seed 0, rope table 512), one model behind two
                AsyncLLMServer replicas of the rung's engine (8 slots,
                chunk 256, block 64, capacity 512, paged, fused, each warmed
                with one 3-token request, then reset and reset_stats), and
                the rung's traffic: 4 trickle streams (64-token prompts, 64
                new tokens each, consumed on their own threads), then a
                flood of 16 prompts of 249-263 tokens with 2 new tokens
                each, through ReplicaRouter. Arms: floor (mixed placement,
                trickle only), mixed (both replicas take everything) and
                disagg (roles prefill [0], decode [1], a FlightRecorder on
                each replica: every request a one-token prefill leg whose
                staged KV ships as PTKV bytes to the decode replica, which
                restores it and recomputes one position). First a wire
                check: bf16 and int8 entries of 5 blocks staged on one
                engine, serialized, deserialized into pinned memory,
                imported into a second engine and restored there, bit for
                bit against the source's blocks, serialize and deserialize
                timed in GB/s. Gates: every request finishes with its
                tokens; the trickle streams and flood tokens equal across
                arms up to a reported near-tie, and pass the greedy check;
                the disagg arm ships all 20 legs with no fallback, its
                decode replica prefills one stitch token a migration, its
                phases serialize/transport/import/place sum to 0.5-1.05x of
                the mean migration latency, 20 migrations are recorded and
                its merged trace holds one flow and four phase spans a
                migration; B3 once a layer a mixed step and B2 once a layer
                a decode iteration, no plain version; the router stops with
                nothing outstanding; every block free or cached, the swap
                and export stores empty, the pool invariants. Per arm
                tokens/s, decode p50/p99, TTFT p99, ship bytes and the
                migration phases (information; the two replicas share one
                card and one stream, so the split's p99 is no capacity
                claim);
  (d-xiii) sampling — on the 32-layer model: the threefry PRNG on the card
                (known answers read off JAX on the CPU: threefry2x32,
                PRNGKey, fold_in, split, bits and uniforms; random bits
                and uniforms over [8, 32000] and [8, 6, 32000], one key
                and a key a row, bit for bit the same functions on CPU
                tensors); 20,000 draws of the engine's sampler from one
                fixed row at top_k 50, top_p 0.9, temperature 0.8 under
                distinct fold_in positions, none outside the keep set and
                a chi-square against the filtered softmax at p > 1e-3;
                sampled generate (B 8, prompt 512, 64 new tokens, 0.8 /
                top_k 50 / 0.9) over the static and the paged cache: B1
                once a layer in the prefill, B2 once a layer a step on the
                paged arm, no plain version, no synchronizing call, and a
                teacher-forced check (the no-cache forward over prompt +
                output, each position re-sampled on the CPU under the same
                keys: a token may differ only at a near-tie, the parted
                pair's perturbed gap or the nearer token's distance to the
                filter's edge under 0.05, and such near-ties are at most 5%
                of the tokens); sampled serving through AsyncLLMServer with
                sampling_seed 7, the (d) prompts every other one sampled
                (0.8 / 0.9) and the rest greedy: the fused paged arm on 32
                layers (the same stream check, with the engine's
                per-(rid, position) keys), then on a 3-layer model at the
                same widths a fused base and the arms legacy,
                readout_stride 8, speculative_k 6 (fused grants over a
                bf16 pool), the legacy dense scan (speculative_k 6), an
                80-block pool with kv_host_swap (preempts, swaps and
                restores) and an int8 pool: every arm's streams equal the
                base's up to a first parting at a near-tie (the int8 arm's
                drift reported, not gated), no synchronizing call in any
                step_begin, kernels on every step; then (information) the
                decode step's ms and tokens/s greedy against sampled in
                one run, the device events and busy ms the sampler adds a
                step, and the sampler alone (device ms, host us, events);
  (e) timing  — each kernel's time, its plain version's, a PyTorch library
                call's where one computes the same function, and the
                card's bound for the same work (B1's and B5's host µs per
                call beside their device time, B2, B3 and B4 also at Hkv 8,
                B3 also at the verify-window step,
                B4-append's two launches apart; B8 at 8, 48 and 128 rows on
                the four 7B-scale shapes, its weight out of L2, beside
                torch._weight_int4pack_mm and a bf16 torch.matmul of the
                same x, and a line over the shapes: fixed cost a call and
                the rate of the rest); then four decode steps of
                a fresh legacy engine traced with torch.profiler (device
                time by kernel class, the device's idle share), and fused
                mixed and all-decode windows at depth 1 and depth 2, untraced
                and traced: no CUDA runtime or driver call that waits on the
                device may run inside a traced step_begin (a second witness
                beside the sync debug mode), and how many launches the host
                can enqueue ahead of a stalled card;
  (f) train   — TrainStep over LlamaForCausalLM(labels=...) at Llama-2-7B
                widths (bf16, seeded random weights, ids and labels as the
                reference's bench line makes them), each run with finite
                losses, the first within 0.5 of ln(vocab), the last below
                the first, every parameter with a grad after each backward,
                and exact kernel launches, plain-chain updates and
                stochastic-rounding warnings per call; step ms, tokens/s,
                MFU and peak memory (information):
                  train: 4 layers, [4, 2048], AdamW with float32 masters and
                    moments, 8 steps: 4 flash forward, 4 dK/dV, 4 dQ and 39
                    AdamW launches per step, no chain update; a traced
                    step; then the AdamW kernel timed over a step's
                    parameters (bf16 and float32 grads) and the flash
                    backward kernels at the training shape;
                  train_accum: the same with accumulate_steps=2 for 4
                    calls: AdamW launches 0, 39, 0, 39 (float32 grads);
                  train_recompute_exact: 2 layers of the bench line's
                    configuration, [6, 2048], recompute off, then on under
                    the full and both dots policies: the same loss, every
                    grad the same bits, the flash forward replayed, a lower
                    peak under the full policy;
                  train_bench_default: the reference bench line's defaults
                    (3 layers, ff 11264, [6, 2048], recompute, bf16
                    moments beside float32 masters), 8 steps: 6 flash
                    forward (forward and replay), 3 dK/dV, 3 dQ, every
                    update on the plain chain; then with fused q/k/v and
                    gate/up projections, 4 steps;
                  train_sr_full_depth: all 32 layers, [4, 2048], recompute,
                    master-free AdamW with stochastic rounding and bf16
                    moments, 8 steps: 64 flash forward, 32 dK/dV, 32 dQ,
                    290 stochastic-rounding launches and one chain update
                    (lm_head, with the reference's warning) per step; then
                    that kernel timed over a step's parameters;
  (g) result  — the kernels line, the card's name and power limit, and the
                ok line, in that order, last.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

# ``--profile-quant ROOT`` profiles the package under ROOT (another
# commit's, unpacked into an ignored directory): imported ahead of this one
if __name__ == "__main__" and sys.argv[1:2] == ["--profile-quant"] and \
        len(sys.argv) == 3:
    sys.path.insert(0, os.path.abspath(sys.argv[2]))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.core.flags import get_flags, set_flags
from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.inference import llm_engine as tle
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels.flash_attention import (
    attention_delta, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.fused_adamw import (
    fused_adamw_sr_update, fused_adamw_sr_update_plain, fused_adamw_update,
    fused_adamw_update_plain, sr_seed, tile_plan)
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.llama import GEN_WINDOW
from paddle_tpu_torch.nn import quant as quant_mod
from paddle_tpu_torch.nn.quant import (WeightOnlyLinear,
                                       int4_routes_to_kernel,
                                       quantize_linears_for_inference,
                                       weight_quantize)
from paddle_tpu_torch.ops.kernels import int4_matmul as i4_mod
from paddle_tpu_torch.ops.kernels import paged_attention as pa_mod
from paddle_tpu_torch.ops.kernels.int4_matmul import (int4_matmul,
                                                      int4_matmul_plain)
from paddle_tpu_torch.ops.kernels.paged_attention import (
    kv_block_scale, kv_packed_dim, kv_quantize, paged_attention_append,
    paged_attention_append_plain, paged_attention_decode,
    paged_attention_decode_plain)
from paddle_tpu_torch.optimizer import AdamW, Optimizer
from paddle_tpu_torch.profiler import FlightRecorder
from paddle_tpu_torch.profiler.flight_recorder import FLOW_EVENT_NAME
from paddle_tpu_torch.serving import (AsyncLLMServer, FaultInjector,
                                      ReplicaRouter, RestartPolicy,
                                      deserialize_entry, serialize_entry)
from paddle_tpu_torch.serving.kv_transport import pool_treedefs
from paddle_tpu_torch.tools.cuda_timing import cuda_ms, host_us
from paddle_tpu_torch.tools import paged_sweep
from paddle_tpu_torch.tools.multi_step_ab import (serve_multi_step_ab,
                                                  serve_stride_arm)

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
PAGED_SRC = "paddle_tpu_torch/csrc/paged_attention_decode.cu"
APPEND_SRC = "paddle_tpu_torch/csrc/paged_attention_append.cu"
BWD_SRC = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
ADAMW_SRC = "paddle_tpu_torch/csrc/fused_adamw.cu"
FLASH_REPLACES = "paddle_tpu/ops/kernels/flash_attention.py:87"
PAGED_REPLACES = "paddle_tpu/ops/kernels/paged_attention.py:370"
APPEND_REPLACES = "paddle_tpu/ops/kernels/paged_attention.py:662"
DKV_REPLACES = "paddle_tpu/ops/kernels/flash_attention.py:174"
DQ_REPLACES = "paddle_tpu/ops/kernels/flash_attention.py:229"
ADAMW_REPLACES = "paddle_tpu/ops/kernels/fused_adamw.py:40"
ADAMW_SR_SRC = "paddle_tpu_torch/csrc/fused_adamw_sr.cu"
ADAMW_SR_REPLACES = "paddle_tpu/ops/kernels/fused_adamw.py:244"
INT4_SRC = "paddle_tpu_torch/csrc/int4_matmul.cu"
INT4_REPLACES = "paddle_tpu/ops/kernels/int4_matmul.py:43"
QUANTS = ("int8", "int4")
KERNELS = _build.KERNELS

FLASH_TOL, LSE_TOL, PAGED_TOL, APPEND_TOL = 2e-2, 1e-2, 1e-2, 2e-2
# flash backward: max |kernel - plain| over max |plain|, per gradient
BWD_REL_TOL = 2e-2
MARGIN = 0.05


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def randn(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# (b) kernel parity
# ---------------------------------------------------------------------------

def flash_case(rng, dev, B, S, Hq, Hkv, D=128):
    return (randn(rng, (B, S, Hq, D), dev), randn(rng, (B, S, Hkv, D), dev),
            randn(rng, (B, S, Hkv, D), dev))


def check_flash(dev):
    rng = np.random.default_rng(1)
    worst = 0.0
    for name, B, S, Hq, Hkv, D, causal in (
            ("main_causal", 2, 2048, 32, 32, 128, True),
            ("main_full", 2, 2048, 32, 32, 128, False),
            ("gqa_causal", 2, 2048, 32, 8, 128, True),
            ("ragged_causal", 2, 1000, 32, 32, 128, True),
            ("ragged_full", 1, 1000, 32, 8, 128, False),
            ("d64_causal", 2, 2048, 32, 8, 64, True),
            ("mqa_causal", 2, 2048, 32, 1, 128, True),
            ("s17_causal", 2, 17, 32, 32, 128, True)):
        q, k, v = flash_case(rng, dev, B, S, Hq, Hkv, D)
        out, lse = flash_attention_fwd(q, k, v, causal)
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        emit({"phase": "parity", "kernel": "flash_attention_fwd",
              "case": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
              "causal": causal, "max_abs_err": err, "lse_max_abs_err": lse_err,
              "tol": FLASH_TOL, "lse_tol": LSE_TOL})
        require(err <= FLASH_TOL and lse_err <= LSE_TOL,
                f"flash {name}: err {err}, lse err {lse_err}")
        worst = max(worst, err)
    return worst


def paged_case(rng, dev, Hkv, lens, wiped, Hq=32, D=128, bs=64, MB=32):
    """Pools and tables covering ``lens`` (+1 decode position each); rows in
    ``wiped`` are freed slots: stale lens, tables all -1 (their write target
    is -1 and lands in the trailing scratch block)."""
    B = len(lens)
    lens = np.asarray(lens, np.int32)
    need = [0 if b in wiped else int(L) // bs + 1 for b, L in enumerate(lens)]
    NB = sum(need) + 2                  # one spare + the scratch block
    order = rng.permutation(NB - 1)
    tables = np.full((B, MB), -1, np.int32)
    it = iter(order)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    return dict(q=randn(rng, (B, Hq, D), dev),
                k=randn(rng, (NB, Hkv, bs, D), dev),
                v=randn(rng, (NB, Hkv, bs, D), dev),
                tables=torch.from_numpy(tables).to(dev),
                lens=torch.from_numpy(lens).to(dev),
                nk=randn(rng, (B, Hkv, D), dev),
                nv=randn(rng, (B, Hkv, D), dev),
                need=need)


PAGED_LENS = [1, 63, 64, 1024, 1500, 2000, 777, 500]   # 64, 1024: boundaries
PAGED_WIPED = (7,)


# a long-context decode batch (MB 128): walks split up to 16 ways, a wiped
# slot, lengths on block edges
PAGED_LONG_LENS = [8191, 5000, 1, 4096, 3000, 777, 8000, 64]
PAGED_LONG_WIPED = (2,)


def check_paged(dev):
    rng = np.random.default_rng(2)
    worst = 0.0
    for name, Hkv, lens, wiped, MB in (
            ("Hkv32", 32, PAGED_LENS, PAGED_WIPED, 32),
            ("Hkv8", 8, PAGED_LENS, PAGED_WIPED, 32),
            ("long_Hkv8", 8, PAGED_LONG_LENS, PAGED_LONG_WIPED, 128)):
        c = paged_case(rng, dev, Hkv, lens, wiped, MB=MB)
        kk, vk = c["k"].clone(), c["v"].clone()
        kp, vp = c["k"].clone(), c["v"].clone()
        out = paged_attention_decode(c["q"], kk, vk, c["tables"], c["lens"],
                                     c["nk"], c["nv"])
        ref = paged_attention_decode_plain(c["q"], kp, vp, c["tables"],
                                           c["lens"], c["nk"], c["nv"])
        err = (out.float() - ref.float()).abs().max().item()
        nb = kk.shape[0]
        pools_exact = bool(torch.equal(kk[:nb - 1], kp[:nb - 1]) and
                           torch.equal(vk[:nb - 1], vp[:nb - 1]))
        written = not torch.equal(kk[:nb - 1], c["k"][:nb - 1])
        span = pa_mod.decode_launch_config(len(lens), 32, Hkv, 128, 64,
                                           MB).span
        emit({"phase": "parity", "kernel": "paged_attention_decode",
              "case": name, "B": len(lens), "Hq": 32, "Hkv": Hkv, "D": 128,
              "block_size": 64, "MB": MB, "lens": lens,
              "wiped_rows": list(wiped), "max_abs_err": err,
              "tol": PAGED_TOL, "pools_exact_except_scratch": pools_exact,
              "new_rows_written": written,
              "splits": [len(pa_mod.decode_walks(L, 64, MB, span))
                         for L in lens]})
        require(err <= PAGED_TOL, f"paged {name}: err {err}")
        require(pools_exact and written,
                f"paged {name}: pools differ outside the scratch block")
        worst = max(worst, err)
    return worst


# (lens, q_lens) per slot: a first chunk, a window starting mid-block and
# crossing five blocks, a short final chunk, a long history, decode rows on
# either side of a block boundary, a long decode, an idle slot (table all -1)
APPEND_SPECS = [(0, 256), (100, 256), (512, 37), (1024, 256), (63, 1),
                (64, 1), (1999, 1), (700, 0)]
# slot 1's window (positions 100-355) runs into a -1 entry at block 4: its
# rows at positions 256-319 land in the scratch block
APPEND_MINUS_ONE = (1, 4)


def append_case(rng, dev, Hkv, specs=APPEND_SPECS, minus_one=None, Hq=32,
                D=128, bs=64, S=256, MB=32):
    """Pools and tables covering each window ``[lens, lens + q_lens)``;
    idle slots (q_lens 0) have an all -1 table row. ``minus_one = (b, j)``
    wipes one table entry of an active slot."""
    B = len(specs)
    need = [0 if q == 0 else (L + q - 1) // bs + 1 for L, q in specs]
    NB = sum(need) + 2                  # one spare + the scratch block
    order = rng.permutation(NB - 1)
    tables = np.full((B, MB), -1, np.int32)
    it = iter(order)
    for b in range(B):
        for j in range(need[b]):
            tables[b, j] = next(it)
    if minus_one is not None:
        tables[minus_one] = -1
    i32 = torch.int32
    return dict(q=randn(rng, (B, S, Hq, D), dev),
                k=randn(rng, (NB, Hkv, bs, D), dev),
                v=randn(rng, (NB, Hkv, bs, D), dev),
                tables=torch.from_numpy(tables).to(dev),
                lens=torch.tensor([L for L, _ in specs], dtype=i32, device=dev),
                qlens=torch.tensor([q for _, q in specs], dtype=i32,
                                   device=dev),
                nk=randn(rng, (B, S, Hkv, D), dev),
                nv=randn(rng, (B, S, Hkv, D), dev))


def append_args(c, k, v):
    return (c["q"], k, v, c["tables"], c["lens"], c["qlens"], c["nk"],
            c["nv"])


# a long-context mixed step (MB 128): decode rows over up to 8,000
# positions (their walks split), chunks and a chunk's tail after long
# histories, an idle slot
APPEND_LONG_SPECS = [(8000, 1), (6000, 256), (4095, 1), (3000, 37),
                     (7000, 1), (0, 256), (100, 0), (5000, 9)]
# a step of speculative verify windows (S 6: the rung's speculative_k):
# q_lens 2-6 after histories of 63, 64, 65 and ~4,000 positions, a window
# crossing a block edge (62 + 5), one whose last rows land on a -1 table
# entry (125 + 6: positions 128-130, block 2 wiped, go to the scratch
# block), an idle slot; MB 64 holds the long histories
VERIFY_SPECS = [(63, 2), (64, 6), (65, 3), (4000, 6), (62, 5), (125, 6),
                (3999, 4), (700, 0)]
VERIFY_MINUS_ONE = (5, 2)
VERIFY_S, VERIFY_MB = 6, 64


def check_append(dev):
    rng = np.random.default_rng(7)
    worst = 0.0
    for name, Hkv, specs, minus_one, MB, S in (
            ("Hkv32", 32, APPEND_SPECS, None, 32, 256),
            ("Hkv8", 8, APPEND_SPECS, None, 32, 256),
            ("minus_one_target", 32, APPEND_SPECS, APPEND_MINUS_ONE, 32, 256),
            ("long_Hkv8", 8, APPEND_LONG_SPECS, None, 128, 256),
            ("verify_windows", 32, VERIFY_SPECS, VERIFY_MINUS_ONE,
             VERIFY_MB, VERIFY_S)):
        c = append_case(rng, dev, Hkv, specs=specs, minus_one=minus_one,
                        MB=MB, S=S)
        kk, vk = c["k"].clone(), c["v"].clone()
        kp, vp = c["k"].clone(), c["v"].clone()
        out = paged_attention_append(*append_args(c, kk, vk))
        ref = paged_attention_append_plain(*append_args(c, kp, vp))
        err, padding_zero = 0.0, True
        for b, (_, n) in enumerate(specs):
            if n:
                err = max(err, (out[b, :n].float() - ref[b, :n].float())
                          .abs().max().item())
            padding_zero &= not bool(out[b, n:].any().item())
        nb = kk.shape[0]
        pools_exact = bool(torch.equal(kk[:nb - 1], kp[:nb - 1]) and
                           torch.equal(vk[:nb - 1], vp[:nb - 1]))
        written = not torch.equal(kk[:nb - 1], c["k"][:nb - 1])
        line = {"phase": "parity", "kernel": "paged_attention_append",
                "case": name, "B": len(specs), "S": S, "Hq": 32,
                "Hkv": Hkv, "D": 128, "block_size": 64, "MB": MB,
                "lens_qlens": specs, "max_abs_err": err,
                "splits": [pa_mod.append_tile_splits(
                    L, n, S, 32 // Hkv, 64, MB)[2] for L, n in specs],
                "tol": APPEND_TOL, "pools_exact_except_scratch": pools_exact,
                "new_rows_written": written, "padding_rows_zero": padding_zero}
        ok = err <= APPEND_TOL and pools_exact and written and padding_zero
        if minus_one is not None:
            # the rows of slot b at positions in the wiped block j sit in
            # scratch, each at its position's offset in a block (the chunk
            # case: rows 156-219 of slot 1, positions 256-319)
            b, j = minus_one
            L, n = specs[b]
            lo, hi = max(L, j * 64), min(L + n, (j + 1) * 64)
            landed = bool(torch.equal(
                kk[nb - 1, :, lo % 64:lo % 64 + hi - lo],
                c["nk"][b, lo - L:hi - L].transpose(0, 1)))
            line["minus_one_rows_in_scratch"] = landed
            ok = ok and landed
        emit(line)
        require(ok, f"append {name}: {line}")
        worst = max(worst, err)
    return worst


def quant_pool(rng, shape, quant, dev, dirty=None):
    """An int8 payload pool and its float32 scales, made by quantizing
    unit-normal blocks with the port's rule. ``dirty = (block, row)``: that
    block's rows from ``row`` on are 100x larger, stale content past the
    live end of a block the step writes."""
    f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    if dirty is not None:
        f[dirty[0], :, dirty[1]:] *= 100.0
    sc = kv_block_scale(f, quant, (2, 3))
    return kv_quantize(f, sc[..., None, None], quant), sc


def pools_equal(got, want):
    """Payload and scales bit-identical outside the scratch block."""
    nb = got[0].shape[0]
    return all(bool(torch.equal(g[:nb - 1], w[:nb - 1]))
               for g, w in zip(got, want))


def paged_quant_case(rng, dev, quant, Hkv, lens=PAGED_LENS,
                     wiped=PAGED_WIPED, bs=64):
    """paged_case's tables and bf16 rows with quantized pools; slot 2's new
    token opens its block 1 (lens 64), whose stale rows past row 0 are
    100x larger."""
    c = paged_case(rng, dev, Hkv, lens, wiped)
    NB, D = c["k"].shape[0], c["q"].shape[-1]
    dirty = (int(c["tables"][2, lens[2] // bs].item()), lens[2] % bs + 1)
    pools = [*quant_pool(rng, (NB, Hkv, bs, D), quant, dev, dirty),
             *quant_pool(rng, (NB, Hkv, bs, D), quant, dev, dirty)]
    c["pools"] = [pools[0], pools[2], pools[1], pools[3]]   # k, v, ks, vs
    c["dirty_block"] = dirty[0]
    return c


# long-context quantized steps: 32 sequences of 8,192 at G 4 (Hkv 8,
# MB 129), made on the card from a seed (numpy takes seconds a pool)
QUANT_LONG_B, QUANT_LONG_L, QUANT_LONG_MB = 32, 8192, 129
QUANT_LONG_QLENS = (1, 16, 5, 16)


def twice_same_bits(fn, pools):
    """``fn(pools)`` on two copies: the same output, payload and scales
    (outside the scratch block, which several CTAs may write)."""
    a = [t.clone() for t in pools]
    b = [t.clone() for t in pools]
    out_a, out_b = fn(a), fn(b)
    torch.cuda.synchronize()
    return bool(torch.equal(out_a, out_b)) and pools_equal(a, b)


def check_paged_quant(dev):
    """B4-decode against its plain version, int8 and int4, at
    check_paged's shapes (Hkv 32 and a GQA case, a wiped slot whose -1
    target parks in scratch, a dirty block) and over 32 sequences of 8,192
    at G 4: payload and scales bit-identical outside scratch, out within
    PAGED_TOL, the same bits on two runs."""
    rng = np.random.default_rng(12)
    worst = {q: 0.0 for q in QUANTS}
    for quant in QUANTS:
        for Hkv in (32, 8, None):
            if Hkv is None:
                q_, kf, vf, t_, ln_, nk_, nv_ = paged_sweep.decode_inputs(
                    paged_sweep.Inputs(16, dev),
                    [QUANT_LONG_L] * QUANT_LONG_B, 32, 8, 128, QUANT_LONG_MB)
                pools = paged_sweep.quantize_pools(kf, vf, quant)
                c = dict(q=q_, tables=t_, lens=ln_, nk=nk_, nv=nv_,
                         pools=list(pools))
                del kf, vf, pools
                name, lens, wiped, Hk = "long_G4", [QUANT_LONG_L] * \
                    QUANT_LONG_B, [], 8
            else:
                c = paged_quant_case(rng, dev, quant, Hkv)
                name, lens, wiped, Hk = f"Hkv{Hkv}", PAGED_LENS, \
                    list(PAGED_WIPED), Hkv
            args = (c["tables"], c["lens"], c["nk"], c["nv"])

            def run(p):
                return paged_attention_decode(
                    c["q"], p[0], p[1], *args, k_scale=p[2], v_scale=p[3],
                    quant=quant)[0]
            got = [t.clone() for t in c["pools"]]
            want = [t.clone() for t in c["pools"]]
            out = run(got)
            ref, *_ = paged_attention_decode_plain(
                c["q"], want[0], want[1], *args, None, want[2], want[3],
                quant)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            exact = pools_equal(got, want)
            written = not torch.equal(got[0][:-1], c["pools"][0][:-1])
            same = twice_same_bits(run, c["pools"])
            line = {"phase": "parity",
                    "kernel": f"paged_attention_decode_{quant}",
                    "case": name, "B": len(lens), "Hq": 32, "Hkv": Hk,
                    "D": 128, "block_size": 64,
                    "payload_dim": kv_packed_dim(128, quant),
                    "lens": lens if Hkv else
                    f"{QUANT_LONG_B} x {QUANT_LONG_L}",
                    "wiped_rows": wiped, "max_abs_err": err,
                    "tol": PAGED_TOL,
                    "payload_and_scales_exact_except_scratch": exact,
                    "blocks_written": written, "same_bits_twice": same}
            clean = True
            if Hkv is not None:
                db = c["dirty_block"]
                clean = bool((got[2][db] < 10 * c["pools"][2].median()).all())
                line["dirty_block_scale_from_live_rows"] = clean
            emit(line)
            require(err <= PAGED_TOL, f"{quant} decode {name}: err {err}")
            require(exact and written and clean and same,
                    f"{quant} decode {name}: {line}")
            worst[quant] = max(worst[quant], err)
            del c, got, want
            torch.cuda.empty_cache()
    return worst


# (lens, q_lens) per slot for the quantized append: APPEND_SPECS, whose
# idle slot (700, 0) keeps a live table here so its blocks can be checked
# unchanged byte for byte
APPEND_Q_IDLE = 7


def append_quant_case(rng, dev, quant, Hkv, minus_one=None, bs=64):
    """append_case's rows with quantized pools and a live table for the
    idle slot; slot 2's window (512 + 37 rows) ends inside block 8 of its
    table, whose rows from 37 on are stale and 100x larger."""
    c = append_case(rng, dev, Hkv, minus_one=minus_one)
    NB, D = c["k"].shape[0], c["q"].shape[-1]
    L_idle = APPEND_SPECS[APPEND_Q_IDLE][0]
    # the idle slot's blocks: appended to the pool, the scratch block
    # moving to the new end
    extra = L_idle // bs + 1
    NB2 = NB + extra
    tables = c["tables"].cpu().numpy()
    tables[APPEND_Q_IDLE, :extra] = np.arange(NB - 1, NB - 1 + extra)
    c["tables"] = torch.from_numpy(tables).to(dev)
    L, q = APPEND_SPECS[2]
    dirty = (int(tables[2, (L + q - 1) // bs]), (L + q) % bs)
    pools = [*quant_pool(rng, (NB2, Hkv, bs, D), quant, dev, dirty),
             *quant_pool(rng, (NB2, Hkv, bs, D), quant, dev, dirty)]
    c["pools"] = [pools[0], pools[2], pools[1], pools[3]]
    c["idle_blocks"] = [int(x) for x in tables[APPEND_Q_IDLE, :extra]]
    c["dirty_block"] = dirty[0]
    return c


def check_append_quant(dev):
    """B4-append against its plain version, int8 and int4, at
    check_append's shapes (Hkv 32, GQA, a -1 window entry) and over 32
    sequences of 8,192 at G 4 (decode rows and short chunk tails at S 16):
    payload and scales bit-identical outside scratch, real rows within
    APPEND_TOL, padding rows zero, the idle slot's blocks unchanged, the
    same bits on two runs."""
    rng = np.random.default_rng(13)
    worst = {q: 0.0 for q in QUANTS}
    long_specs = [(QUANT_LONG_L - n, n)
                  for n in QUANT_LONG_QLENS * (QUANT_LONG_B // 4)]
    for quant in QUANTS:
        for name, Hkv, minus_one in (("Hkv32", 32, None), ("Hkv8", 8, None),
                                     ("minus_one_target", 32,
                                      APPEND_MINUS_ONE),
                                     ("long_G4", 8, None)):
            if name == "long_G4":
                specs = long_specs
                q_, kf, vf, t_, ln_, ql_, nk_, nv_ = \
                    paged_sweep.append_inputs(paged_sweep.Inputs(17, dev),
                                              specs, 32, 8, 128,
                                              QUANT_LONG_MB, S=16)
                pools = paged_sweep.quantize_pools(kf, vf, quant)
                c = dict(q=q_, tables=t_, lens=ln_, qlens=ql_, nk=nk_,
                         nv=nv_, pools=list(pools))
                del kf, vf, pools
            else:
                specs = APPEND_SPECS
                c = append_quant_case(rng, dev, quant, Hkv, minus_one)
            rows = (c["tables"], c["lens"], c["qlens"], c["nk"], c["nv"])

            def run(p):
                return paged_attention_append(
                    c["q"], p[0], p[1], *rows, k_scale=p[2], v_scale=p[3],
                    quant=quant)[0]
            got = [t.clone() for t in c["pools"]]
            want = [t.clone() for t in c["pools"]]
            out = run(got)
            ref, *_ = paged_attention_append_plain(
                c["q"], want[0], want[1], *rows, None, want[2], want[3],
                quant)
            torch.cuda.synchronize()
            err, padding_zero = 0.0, True
            for b, (_, n) in enumerate(specs):
                if n:
                    err = max(err, (out[b, :n].float() - ref[b, :n].float())
                              .abs().max().item())
                padding_zero &= not bool(out[b, n:].any().item())
            exact = pools_equal(got, want)
            same = twice_same_bits(run, c["pools"])
            S = c["q"].shape[1]
            line = {"phase": "parity",
                    "kernel": f"paged_attention_append_{quant}",
                    "case": name, "B": len(specs), "S": S, "Hq": 32,
                    "Hkv": Hkv, "D": 128, "block_size": 64,
                    "payload_dim": kv_packed_dim(128, quant),
                    "lens_qlens": specs if name != "long_G4" else
                    f"{QUANT_LONG_B} x (8192 - q, q), q in "
                    f"{list(QUANT_LONG_QLENS)}",
                    "max_abs_err": err, "tol": APPEND_TOL,
                    "payload_and_scales_exact_except_scratch": exact,
                    "padding_rows_zero": padding_zero,
                    "same_bits_twice": same}
            ok = err <= APPEND_TOL and exact and padding_zero and same
            if name != "long_G4":
                idle = c["idle_blocks"]
                unchanged = all(bool(torch.equal(g[idle], o[idle]))
                                for g, o in zip(got, c["pools"]))
                db = c["dirty_block"]
                clean = bool((got[2][db] < 10 * c["pools"][2].median()).all())
                line.update(idle_slot_blocks_unchanged=unchanged,
                            dirty_block_scale_from_live_rows=clean)
                ok = ok and unchanged and clean
            emit(line)
            require(ok, f"{quant} append {name}: {line}")
            worst[quant] = max(worst[quant], err)
            del c, got, want
            torch.cuda.empty_cache()
    return worst


def rel_err(a, b):
    """max |a - b| over max |b|, in float32."""
    return ((a.float() - b.float()).abs().max() /
            b.float().abs().max()).item()


def check_flash_bwd(dev):
    """The dK/dV and dQ kernels against their plain versions on one lse and
    delta from the forward kernel: the training shape (causal MHA), a GQA
    case, a dropout case whose forward is checked too (same seed), head dim
    64, one kv head under a group of 32, and a ragged full case."""
    rng = np.random.default_rng(11)
    worst = {"flash_attention_bwd_dkv": 0.0, "flash_attention_bwd_dq": 0.0}
    for name, B, S, Hq, Hkv, D, causal, p in (
            ("train_causal", 4, 2048, 32, 32, 128, True, 0.0),
            ("gqa_causal", 2, 2048, 32, 8, 128, True, 0.0),
            ("dropout_causal", 1, 512, 8, 8, 128, True, 0.1),
            ("d64_gqa_causal", 2, 2048, 32, 8, 64, True, 0.0),
            ("mqa_causal", 1, 2048, 32, 1, 128, True, 0.0),
            ("ragged_full", 2, 1000, 16, 4, 128, False, 0.0)):
        q, k, v = flash_case(rng, dev, B, S, Hq, Hkv, D)
        do = randn(rng, (B, S, Hq, D), dev)
        seed = 20261016
        out, lse = flash_attention_fwd(q, k, v, causal, None, p, seed)
        line = {"phase": "parity", "kernel": "flash_attention_bwd",
                "case": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                "causal": causal, "dropout_p": p, "tol_rel": BWD_REL_TOL}
        if p > 0.0:
            ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal, None, p,
                                                     seed)
            line["fwd_max_abs_err"] = (out.float() - ref.float()).abs() \
                .max().item()
            line["fwd_lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
            require(line["fwd_max_abs_err"] <= FLASH_TOL and
                    line["fwd_lse_max_abs_err"] <= LSE_TOL,
                    f"flash dropout forward {name}: {line}")
            del ref, ref_lse
        delta = attention_delta(out, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                         None, p, seed)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, None, p,
                                    seed)
        torch.cuda.synchronize()
        rk, rv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal, None, p, seed)
        torch.cuda.empty_cache()
        rq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                          None, p, seed)
        errs = {"dq": rel_err(dq, rq), "dk": rel_err(dk, rk),
                "dv": rel_err(dv, rv)}
        line["rel_err"] = errs
        line["max_abs_err"] = {"dq": (dq.float() - rq.float()).abs().max()
                               .item(),
                               "dk": (dk.float() - rk.float()).abs().max()
                               .item(),
                               "dv": (dv.float() - rv.float()).abs().max()
                               .item()}
        emit(line)
        require(all(e <= BWD_REL_TOL for e in errs.values()),
                f"flash backward {name}: {errs}")
        worst["flash_attention_bwd_dkv"] = max(
            worst["flash_attention_bwd_dkv"], line["max_abs_err"]["dk"],
            line["max_abs_err"]["dv"])
        worst["flash_attention_bwd_dq"] = max(
            worst["flash_attention_bwd_dq"], line["max_abs_err"]["dq"])
        del q, k, v, do, out, lse, delta, dk, dv, dq, rk, rv, rq
        torch.cuda.empty_cache()
    return worst


def adamw_state(rng, shape, dev, step):
    """A bf16 param, its bf16 grad and float32 moments and master at a
    mid-run state (zero moments at step 1)."""
    f = np.float32
    mw = torch.from_numpy(rng.standard_normal(shape).astype(f) * f(0.02)) \
        .to(dev)
    g = torch.from_numpy(rng.standard_normal(shape).astype(f) * f(1e-3)) \
        .to(dev).to(torch.bfloat16)
    m = torch.from_numpy(rng.standard_normal(shape).astype(f) * f(1e-4)) \
        .to(dev) * (step > 1)
    v = torch.from_numpy(rng.random(shape).astype(f) * f(1e-7)).to(dev) \
        * (step > 1)
    return mw.to(torch.bfloat16), g, m, v, mw


ADAMW_SHAPE = (4096, 11008)


def check_adamw(dev):
    """The AdamW kernel against its plain version on a [4096, 11008]
    tensor at steps 1 and 7, decay on and off, with a bf16 grad and with a
    float32 grad (an accumulated mean): m, v, master and the bf16 param
    bit-identical."""
    rng = np.random.default_rng(12)
    worst = 0.0
    for gdt in (torch.bfloat16, torch.float32):
        for step, decay in ((1, True), (1, False), (7, True), (7, False)):
            a = list(adamw_state(rng, ADAMW_SHAPE, dev, step))
            a[1] = a[1].to(gdt)
            b = tuple(t.clone() for t in a)
            before = a[4].clone()
            fused_adamw_update(*a, 3e-4, step, weight_decay=0.01,
                               apply_decay=decay)
            fused_adamw_update_plain(*b, 3e-4, step, weight_decay=0.01,
                                     apply_decay=decay)
            same = {n: bool(torch.equal(x, y))
                    for n, x, y in zip(("p", "g", "m", "v", "master"), a, b)}
            err = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(a, b))
            moved = not torch.equal(a[4], before)
            emit({"phase": "parity", "kernel": "fused_adamw", "shape":
                  list(ADAMW_SHAPE), "grad_dtype": str(gdt), "step": step,
                  "apply_decay": decay, "bit_identical": same,
                  "max_abs_err": err})
            require(all(same.values()) and moved,
                    f"adamw {gdt} step {step} decay {decay}: {same}")
            worst = max(worst, err)
            del a, b
    torch.cuda.empty_cache()
    return worst


def check_adamw_sr(dev):
    """The stochastic-rounding AdamW kernel against its plain version on a
    [4096, 11008] tensor (bf16 param and moments) at steps 1 and 7, decay
    on and off, with a bf16 and a float32 grad: param and moments
    bit-identical, and the param moved."""
    rng = np.random.default_rng(16)
    worst = 0.0
    for gdt in (torch.bfloat16, torch.float32):
        for step, decay in ((1, True), (1, False), (7, True), (7, False)):
            mw, g, m, v, _ = adamw_state(rng, ADAMW_SHAPE, dev, step)
            a = (mw, g.to(gdt), m.to(torch.bfloat16), v.to(torch.bfloat16))
            b = tuple(t.clone() for t in a)
            before = mw.clone()
            seed = sr_seed(step, 7)
            fused_adamw_sr_update(*a, 3e-4, step, seed, weight_decay=0.01,
                                  apply_decay=decay)
            fused_adamw_sr_update_plain(*b, 3e-4, step, seed,
                                        weight_decay=0.01, apply_decay=decay)
            same = {n: bool(torch.equal(x, y))
                    for n, x, y in zip(("p", "g", "m", "v"), a, b)}
            err = max((x.float() - y.float()).abs().max().item()
                      for x, y in zip(a, b))
            moved = not torch.equal(a[0], before)
            emit({"phase": "parity", "kernel": "fused_adamw_sr", "shape":
                  list(ADAMW_SHAPE), "grad_dtype": str(gdt), "step": step,
                  "apply_decay": decay, "seed": seed, "bit_identical": same,
                  "max_abs_err": err})
            require(all(same.values()) and moved,
                    f"adamw_sr {gdt} step {step} decay {decay}: {same}")
            worst = max(worst, err)
            del a, b
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# (c) forward, (d) serving, (d') fused serving
# ---------------------------------------------------------------------------

def build_model(dev, **over):
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16", **over)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    return model


def run_forward(model, dev):
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.config.vocab_size, size=(2, 2048))).to(dev)
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    L = model.config.num_hidden_layers
    finite = bool(torch.isfinite(logits).all().item())
    emit({"phase": "forward", "shape": list(logits.shape),
          "dtype": str(logits.dtype), "finite": finite,
          "flash_launches": launches, "expected_launches": L,
          "wall_ms_first_call": wall * 1e3})
    require(tuple(logits.shape) == (2, 2048, model.config.vocab_size),
            f"forward logits shape {tuple(logits.shape)}")
    require(finite, "forward logits are not finite")
    require(launches == L, f"flash launches {launches} != {L}")
    return launches


def profile_decode(model, dev, n_steps=4):
    """Where a decode step's time goes: admit the serving run's first eight
    requests into a fresh engine, then trace ``n_steps`` pure decode steps
    with torch.profiler (run last: the tracer slows later host launches)."""
    eng = make_engine(model, dev)
    for p in serving_prompts(model.config.vocab_size)[:8]:
        eng.add_request(p, max_new_tokens=64)
    for _ in range(2):                 # admission + prefill, one warm step
        eng.step()
    torch.cuda.synchronize()
    n0 = int4_matmul.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    win = device_breakdown(prof, wall, n_steps)
    if win is not None:
        win["int4_matmul_launches"] = int4_matmul.launches - n0
    return win


def make_engine(model, dev):
    return LLMEngine(model, cache_impl="paged", scheduler="legacy",
                     max_batch=8, block_size=64, chunk_size=256,
                     max_seq_len=2048, device=dev)


def serving_prompts(vocab):
    rng = np.random.default_rng(4)
    lens = rng.integers(100, 1501, size=12)
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32)
            for n in lens]


SERVING_CLASSES = (("paged_decode_kernel", ("paged_decode_kernel",)),
                   ("append_kernels", ("append_split_kernel",
                                       "append_write_kernel",
                                       "append_quant_write_kernel")),
                   # B8 by its name stem, so a commit whose B8 launches
                   # other kernels (a first form's partial and reduce) is
                   # classed alike
                   ("int4_gemm", ("int4_mm",)))
# the quantized arms' windows: B4-append's two launches apart, by the
# kernels' name stems (the write pass first, then any other append kernel),
# so a commit whose B4 kernels are named otherwise is classed alike
QUANT_CLASSES = (("paged_decode_kernel", ("paged_decode",)),
                 ("append_write", ("append_quant_write",)),
                 ("append_attention", ("append_",)))
TRAIN_CLASSES = (("flash_forward", ("flash_fwd_kernel",)),
                 ("flash_backward", ("flash_bwd_dkv_kernel",
                                     "flash_bwd_dq_kernel")),
                 ("adamw", ("adamw_kernel",)),
                 ("adamw_sr", ("adamw_sr_kernel",)))


def device_breakdown(prof, wall_s, n_steps, classes=SERVING_CLASSES):
    """Sum the device events (kernels, copies, sets) of a finished
    profile per step: total busy time (union of intervals), each named
    class of kernels (by substrings of the kernel's name; the serving
    phases' default: the paged-decode kernel and the paged-append kernel's
    two launches), matrix products, everything else, and the device's idle
    share of the traced wall. None when the trace holds no device event."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev = [e for e in events if e.get("ph") == "X" and
           e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return None
    by = {key: 0.0 for key, _ in classes}
    by.update(gemm=0.0, other=0.0)
    count = dict.fromkeys(by, 0)
    names = {key: set() for key, _ in classes}
    spans = []
    for e in dev:
        name = e.get("name", "")
        key, ident = next(((k, re.search(r"\w*%s\w*" % re.escape(t), name)
                            .group(0))
                           for k, subs in classes for t in subs
                           if t in name), (None, None))
        if key is None:
            key = "gemm" if any(t in name.lower() for t in (
                "gemm", "xmma", "cutlass", "nvjet")) else "other"
        by[key] += e["dur"]
        count[key] += 1
        if key in names:
            names[key].add(ident)
        spans.append((e["ts"], e["ts"] + e["dur"]))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s0, s1 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    return {"steps": n_steps, "wall_ms_per_step": wall_s * 1e3 / n_steps,
            "device_busy_ms_per_step": busy / 1e3 / n_steps,
            "device_ms_per_step_by_kernel": {
                k: v / 1e3 / n_steps for k, v in by.items()},
            "device_idle_share": max(0.0, 1.0 - busy / 1e6 / wall_s),
            "events_per_step": len(dev) / n_steps,
            "events_per_step_by_kernel": {
                k: v / n_steps for k, v in count.items()},
            "kernel_names_by_class": {k: sorted(v) for k, v in names.items()}}


def run_serving(model, dev):
    prompts = serving_prompts(model.config.vocab_size)
    lens = [len(p) for p in prompts]
    eng = make_engine(model, dev)
    rids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    flash_attention_fwd.launches = 0
    paged_attention_decode.launches = 0
    step_walls, decode_walls, admit_chunks, syncs = [], [], [], []
    t_all = time.perf_counter()
    while eng.has_unfinished():
        c0 = eng.stats["prefill_chunks"]
        t0 = time.perf_counter()
        with sync_watch(syncs):
            pending = eng.step_begin()
        if pending is not None:
            eng.step_finish(pending)   # waits on the step's own event
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        step_walls.append(dt)
        n_chunks = eng.stats["prefill_chunks"] - c0
        admit_chunks.append(n_chunks)
        if n_chunks == 0:
            decode_walls.append(dt)
    wall = time.perf_counter() - t_all
    paged_launches = paged_attention_decode.launches
    flash_launches = flash_attention_fwd.launches
    L = model.config.num_hidden_layers
    steps = eng.stats["steps"]
    outs = [eng.finished_outputs.pop(r) for r in rids]
    n_tok = sum(len(o.token_ids) for o in outs)
    decode_ms = float(np.median(decode_walls)) * 1e3
    # admission steps also decode: their excess over a plain decode step is
    # the prefill they ran
    prefill_s = sum(w - decode_ms / 1e3 for w, n in
                    zip(step_walls, admit_chunks) if n)
    n_chunks = eng.stats["prefill_chunks"]

    checked, excused, mismatched = greedy_check(model, dev, prompts, outs)
    emit({"phase": "serving", "requests": len(outs),
          "prompt_lens": [int(n) for n in lens], "new_tokens": 64,
          "finished": sum(o.finished for o in outs),
          "finish_reasons": sorted({o.finish_reason for o in outs}),
          "tokens": n_tok, "steps": steps,
          "paged_decode_launches": paged_launches,
          "expected_launches": steps * L,
          "flash_launches": flash_launches, "prefill_chunks": n_chunks,
          "preemptions": eng.stats["preemptions"],
          "wall_s": wall, "tokens_per_s": n_tok / wall,
          "decode_step_ms_median": decode_ms,
          "prefill_ms_per_chunk": prefill_s * 1e3 / max(n_chunks, 1),
          "step_begin_syncs": len(syncs),
          "step_begin_sync_messages": sorted(set(syncs))[:5],
          "greedy_checked": checked, "greedy_excused_near_ties": excused,
          "greedy_mismatched": mismatched, "margin": MARGIN})
    require(not syncs, f"step_begin made {len(syncs)} synchronizing calls")
    require(all(o.finished and o.finish_reason == "length" and
                len(o.token_ids) == 64 for o in outs),
            "a request did not finish with its 64 tokens")
    require(paged_launches == steps * L and paged_launches > 0,
            f"decode launches {paged_launches} != steps {steps} x {L}")
    require(mismatched == 0, f"{mismatched} greedy tokens disagree with the "
            f"no-cache forward beyond the {MARGIN} margin")
    return paged_launches, [list(o.token_ids) for o in outs]


def greedy_check(model, dev, prompts, outs, margin=MARGIN):
    """Each token against a no-cache forward over its prefix: returns
    (checked, excused near-ties under ``margin``, mismatched)."""
    checked = excused = mismatched = 0
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            seq = np.concatenate([p, np.asarray(o.token_ids[:-1], np.int32)])
            logits = model(torch.from_numpy(seq[None]).to(dev))[0].float()
            rows = logits[len(p) - 1:len(p) - 1 + len(o.token_ids)]
            top2 = torch.topk(rows, 2, dim=-1)
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            arg = top2.indices[:, 0].cpu().numpy()
            for i, tok in enumerate(o.token_ids):
                if gap[i] > margin:
                    checked += 1
                    mismatched += int(arg[i] != tok)
                else:
                    excused += 1
    return checked, excused, mismatched


def make_fused_engine(model, dev, **kw):
    return LLMEngine(model, **{**dict(
        cache_impl="paged", scheduler="fused", max_batch=8, block_size=64,
        chunk_size=256, max_seq_len=2048, device=dev), **kw})


@contextlib.contextmanager
def sync_watch(seen):
    """CUDA's sync debug mode around a dispatch: the message of every
    synchronizing call inside it (a blocking copy, ``.item()``, a stream
    sync) is appended to ``seen``."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    seen.extend(str(w.message) for w in caught
                if "synchroniz" in str(w.message))


def begin_step(eng, syncs, inflight=None):
    """``step_begin`` (its synchronizing calls appended to ``syncs``) plus
    what kind of step it dispatched: (pending, kind, real rows, probe), kind
    "mixed", "decode" or None (nothing dispatched). ``inflight`` is the
    entry of the step still in flight, if any. The probe holds the host ms
    of ``step_begin``, CUDA events around the step's device work, and
    whether the in-flight step was still running on the device when
    ``step_begin`` returned (it is not when ``step_begin`` waited on the
    device, by a sync or by launches that found CUDA's launch queue
    full)."""
    f0, p0 = eng.stats["fused_steps"], eng.stats["prefill_tokens"]
    on_card = eng.device.type == "cuda"
    start = end = None
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    with sync_watch(syncs):
        pending = eng.step_begin()
    host_ms = (time.perf_counter() - t0) * 1e3
    prev = inflight[0] if inflight is not None else None
    prev_running = (on_card and prev is not None and prev.event is not None
                    and not prev.event.query())
    if on_card:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    if pending is None:
        return None
    probe = {"host_ms": host_ms, "start": start, "end": end,
             "inflight_kind": inflight[1] if inflight is not None else None,
             "inflight_running": prev_running}
    if pending.toks is None:
        return pending, None, 0, probe
    mixed = eng.stats["fused_steps"] > f0
    rows = eng.stats["prefill_tokens"] - p0 + sum(pending.sched.values())
    return pending, "mixed" if mixed else "decode", rows, probe


def overlap_summary(probes):
    """The mixed steps dispatched while another mixed step was in flight
    (read after a synchronize): ``step_begin``'s host ms against the
    step's device ms, and how many found the in-flight step still running
    on the device when they returned."""
    steady = [p for p in probes if p["kind"] == "mixed"
              and p["inflight_kind"] == "mixed"]
    host = [p["host_ms"] for p in steady]
    device = [p["start"].elapsed_time(p["end"]) for p in steady
              if p["start"] is not None]
    return {"steady_mixed_steps": len(steady),
            "mixed_begin_host_ms_median":
                float(np.median(host)) if host else None,
            "mixed_begin_host_ms_max": max(host) if host else None,
            "mixed_device_ms_median":
                float(np.median(device)) if device else None,
            "mixed_begins_with_inflight_running":
                sum(p["inflight_running"] for p in steady)}


def run_fused_serving(model, dev, legacy_tokens):
    """The 12 requests through the fused scheduler, pipelined at depth 2
    (step_begin of step N+1 before step_finish of step N)."""
    prompts = serving_prompts(model.config.vocab_size)
    first_token_s = {}
    clock = {"start": 0.0, "prev": 0.0}

    def on_token(rid, _tok):
        first_token_s.setdefault(rid, time.perf_counter() - clock["start"])

    eng = make_fused_engine(model, dev, stream_callback=on_token)
    rids = [eng.add_request(p, max_new_tokens=64) for p in prompts]
    step_ms = {"mixed": [], "decode": []}
    mixed_rows = []
    probes = []

    def finish(entry):
        pending, kind, rows, probe = entry
        eng.step_finish(pending)
        now = time.perf_counter()
        if kind is not None:
            step_ms[kind].append((now - clock["prev"]) * 1e3)
            probes.append(dict(probe, kind=kind))
            if kind == "mixed":
                mixed_rows.append(rows)
        clock["prev"] = now

    syncs = []
    flash_attention_fwd.launches = 0
    paged_attention_decode.launches = 0
    paged_attention_append.launches = 0
    clock["start"] = clock["prev"] = time.perf_counter()
    entry = begin_step(eng, syncs)
    while eng.has_unfinished():
        nxt = begin_step(eng, syncs, entry) if entry is not None else None
        if entry is not None:
            finish(entry)
        entry = nxt
        if entry is None and eng.has_unfinished():
            entry = begin_step(eng, syncs)
    if entry is not None:
        finish(entry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - clock["start"]
    overlap = overlap_summary(probes)
    append_launches = paged_attention_append.launches
    decode_launches = paged_attention_decode.launches
    flash_launches = flash_attention_fwd.launches
    L = model.config.num_hidden_layers
    n_mixed = eng.stats["fused_steps"]
    n_decode = eng.stats["steps"] - n_mixed
    outs = [eng.finished_outputs.pop(r) for r in rids]
    n_tok = sum(len(o.token_ids) for o in outs)
    all_free = len(eng._free_blocks) == eng.n_blocks
    same = sum(int(a == b) for o, ref in zip(outs, legacy_tokens)
               for a, b in zip(o.token_ids, ref))
    rows_capacity = eng.B * eng.chunk
    real_share = sum(mixed_rows) / max(len(mixed_rows) * rows_capacity, 1)
    del eng
    torch.cuda.empty_cache()
    checked, excused, mismatched = greedy_check(model, dev, prompts, outs)
    ttft = [first_token_s.get(r) for r in rids]
    emit({"phase": "fused_serving", "requests": len(outs),
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
          "pipeline_depth": 2, "finished": sum(o.finished for o in outs),
          "finish_reasons": sorted({o.finish_reason for o in outs}),
          "tokens": n_tok, "mixed_steps": n_mixed,
          "all_decode_steps": n_decode,
          "append_launches": append_launches,
          "expected_append_launches": n_mixed * L,
          "decode_launches": decode_launches,
          "expected_decode_launches": n_decode * L,
          "flash_launches": flash_launches,
          "wall_s": wall, "tokens_per_s": n_tok / wall,
          "decode_step_ms_median": float(np.median(step_ms["decode"])),
          "mixed_step_ms_median": float(np.median(step_ms["mixed"])),
          "ttft_s": ttft, "ttft_s_median": float(np.median(ttft)),
          "mixed_real_rows": int(sum(mixed_rows)),
          "mixed_row_slots": len(mixed_rows) * rows_capacity,
          "mixed_real_row_share": real_share,
          "tokens_equal_to_legacy_phase": same,
          "blocks_all_free": all_free,
          "step_begin_syncs": len(syncs),
          "step_begin_sync_messages": sorted(set(syncs))[:5],
          "overlap": overlap,
          "greedy_checked": checked, "greedy_excused_near_ties": excused,
          "greedy_mismatched": mismatched, "margin": MARGIN})
    require(not syncs, f"fused: step_begin made {len(syncs)} synchronizing "
            f"calls")
    require(all(o.finished and o.finish_reason == "length" and
                len(o.token_ids) == 64 for o in outs),
            "fused: a request did not finish with its 64 tokens")
    require(append_launches == n_mixed * L and append_launches > 0,
            f"fused: append launches {append_launches} != mixed steps "
            f"{n_mixed} x {L}")
    require(decode_launches == n_decode * L and decode_launches > 0,
            f"fused: decode launches {decode_launches} != all-decode steps "
            f"{n_decode} x {L}")
    require(mismatched == 0, f"fused: {mismatched} greedy tokens disagree "
            f"with the no-cache forward beyond the {MARGIN} margin")
    require(all_free, "fused: blocks still allocated after the drain")
    return append_launches, decode_launches, [list(o.token_ids) for o in outs]


BEGIN_SPAN = "chip_smoke::step_begin"
# runtime and driver calls that make the host wait on the device
SYNC_CALLS = ("Synchronize", "cudaMemcpy", "cudaMemcpy2D", "cudaFree",
              "cudaFreeHost", "cuMemFree", "cuMemFreeHost", "cuMemcpyDtoH",
              "cuMemcpyHtoD")


def is_sync_call(name):
    return "Synchronize" in name or (name in SYNC_CALLS) or \
        any(name.startswith(c + "_v") for c in SYNC_CALLS)


def run_window(eng, n, depth):
    """Dispatch ``n`` steps keeping up to ``depth`` in flight, each
    ``step_begin`` inside a ``BEGIN_SPAN`` profiler range; returns the wall
    ms per step (ending in a synchronize), how many were mixed, and the
    host ms of each ``step_begin``."""
    f0 = eng.stats["fused_steps"]
    pend = collections.deque()
    begin_ms = []
    t0 = time.perf_counter()
    for _ in range(n):
        if len(pend) == depth:
            eng.step_finish(pend.popleft())
        tb = time.perf_counter()
        with record_function(BEGIN_SPAN):
            pending = eng.step_begin()
        begin_ms.append((time.perf_counter() - tb) * 1e3)
        require(pending is not None and pending.toks is not None,
                "profile window: a step dispatched nothing")
        pend.append(pending)
    while pend:
        eng.step_finish(pend.popleft())
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / n,
            eng.stats["fused_steps"] - f0, begin_ms)


def runtime_in_begin(prof):
    """The CUDA runtime and driver calls the trace saw inside each
    ``BEGIN_SPAN`` (CUPTI sees every one, whoever issues it): how many,
    and the names of those that make the host wait on the device."""
    host = torch.autograd.DeviceType.CPU        # not the device-track copies
    evs = [e for e in prof.events() if e.device_type == host]
    spans = [(e.time_range.start, e.time_range.end) for e in evs
             if e.name == BEGIN_SPAN]
    calls, syncs = 0, []
    for e in evs:
        if not e.name.startswith("cu"):
            continue
        t = e.time_range.start
        if any(a <= t <= b for a, b in spans):
            calls += 1
            if is_sync_call(e.name):
                syncs.append(e.name)
    return {"begin_spans": len(spans), "runtime_calls": calls,
            "sync_calls": syncs}


def launch_queue_depth(dev, limit=20000, blocked_ms=5.0):
    """How many one-kernel launches the host can enqueue behind a stalled
    device before a launch blocks: the most a ``step_begin`` can run ahead
    of the card, whatever the pipeline depth."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))                  # ~0.5 s of device time
    n = 0
    while n < limit:
        t0 = time.perf_counter()
        x.add_(1)
        if (time.perf_counter() - t0) * 1e3 > blocked_ms:
            break
        n += 1
    torch.cuda.synchronize()
    return n


def profile_fused(model, dev, n_steps=4):
    """Whether pipelining overlaps: the serving run's first eight requests
    in a fresh fused engine; windows of ``n_steps`` mixed steps (during the
    ramp-in) and then all-decode steps. Untraced windows run at depths 1,
    2, 2, 1 (wall per step and host ms per step_begin; the alternation
    cancels drift), then one traced window at each depth (device busy, idle
    share, and the runtime calls inside each step_begin: none may wait on
    the device)."""
    eng = make_fused_engine(model, dev)
    for p in serving_prompts(model.config.vocab_size)[:8]:
        eng.add_request(p, max_new_tokens=64)
    run_window(eng, 2, 1)                         # warm
    res = {}
    for kind in ("mixed", "decode"):
        if kind == "decode":
            while any(s is not None and s.ramping for s in eng.slots):
                eng.step()
        want = n_steps if kind == "mixed" else 0
        untraced = {1: [], 2: []}
        begin_ms = {1: [], 2: []}
        for depth in (1, 2, 2, 1):
            wall_ms, n_mixed, b_ms = run_window(eng, n_steps, depth)
            require(n_mixed == want, f"profile {kind} depth {depth}: "
                    f"{n_mixed} mixed steps of {n_steps}")
            untraced[depth].append(wall_ms)
            begin_ms[depth].extend(b_ms)
        for depth in (1, 2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, n_mixed, _ = run_window(eng, n_steps, depth)
                wall = time.perf_counter() - t0
            require(n_mixed == want, f"traced profile {kind} depth "
                    f"{depth}: {n_mixed} mixed steps of {n_steps}")
            rt = runtime_in_begin(prof)
            res[f"{kind}_depth{depth}"] = {
                "untraced_wall_ms_per_step": untraced[depth],
                "untraced_step_begin_ms_median":
                    float(np.median(begin_ms[depth])),
                "traced": device_breakdown(prof, wall, n_steps),
                "step_begin_runtime": rt}
            require(rt["begin_spans"] == n_steps and rt["runtime_calls"] > 0,
                    f"profile {kind} depth {depth}: the trace holds "
                    f"{rt['begin_spans']} step_begin spans with "
                    f"{rt['runtime_calls']} runtime calls")
            require(not rt["sync_calls"],
                    f"profile {kind} depth {depth}: step_begin made "
                    f"synchronizing runtime calls {sorted(set(rt['sync_calls']))}")
    res["launch_queue_depth"] = launch_queue_depth(dev)
    return res


# ---------------------------------------------------------------------------
# (e) timing and bounds
# ---------------------------------------------------------------------------

def time_flash(dev):
    B, S, H, D = 2, 2048, 32, 128
    q, k, v = flash_case(np.random.default_rng(5), dev, B, S, H, H, D)
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, True), 20)
    dropout_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, True, None, 0.1,
                                                     7), 20)
    # the wrapper's host cost: checks, three tensor maps encoded, the launch
    call_us = host_us(lambda: flash_attention_fwd(q, k, v, True))
    plain_ms = cuda_ms(lambda: flash_attention_fwd_plain(q, k, v, True), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    pairs = B * H * S * (S + 1) // 2            # visible (query, key) pairs
    ops = 4 * D * pairs
    nbytes = 2 * (4 * B * S * H * D) + 4 * B * H * S
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                shape=[B, S, H, D], causal=True, ops=ops, bytes=nbytes,
                dropout_0_1_ms=dropout_ms, host_us_per_call=call_us)


def time_paged(dev):
    """B2 at the timing shape (Hkv 32, PAGED_LENS, a wiped slot), and at
    the same lens with Hkv 8 (G 4) under "hkv8": device ms, host µs per
    call, bound (``paged_sweep.decode_bound``: what this data needs)."""
    def one(Hkv):
        c = paged_case(np.random.default_rng(6), dev, Hkv, PAGED_LENS,
                       PAGED_WIPED)
        args = (c["q"], c["k"], c["v"], c["tables"], c["lens"], c["nk"],
                c["nv"])
        B, Hq, D = c["q"].shape
        return dict(ms=cuda_ms(lambda: paged_attention_decode(*args), 50),
                    host_us_per_call=host_us(
                        lambda: paged_attention_decode(*args)),
                    **paged_sweep.decode_bound(PAGED_LENS, Hq, Hkv, D,
                                               wiped=PAGED_WIPED),
                    shape=dict(B=B, Hq=Hq, Hkv=Hkv, D=D, block_size=64,
                               lens=PAGED_LENS)), args
    out, args = one(32)
    out.update(plain_ms=cuda_ms(lambda: paged_attention_decode_plain(*args),
                                5),
               library_ms=None, hkv8=one(8)[0])
    return out


def time_append(dev):
    """B3 at the timing shape (APPEND_SPECS, Hkv 32), and with Hkv 8 (G 4)
    under "hkv8": device ms, host µs per call, bound
    (``paged_sweep.append_bound``: each live slot's history read once, the
    chunk's new K/V read and written once, not the kernel's second read
    of them out of the pool)."""
    def one(Hkv):
        c = append_case(np.random.default_rng(8), dev, Hkv)
        args = append_args(c, c["k"], c["v"])
        B, S, Hq, D = c["q"].shape
        real = sum(q for _, q in APPEND_SPECS)
        pairs = sum(q * L + q * (q + 1) // 2 for L, q in APPEND_SPECS)
        return dict(ms=cuda_ms(lambda: paged_attention_append(*args), 50),
                    host_us_per_call=host_us(
                        lambda: paged_attention_append(*args)),
                    **paged_sweep.append_bound(APPEND_SPECS, Hq, Hkv, D),
                    shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, block_size=64,
                               lens_qlens=APPEND_SPECS),
                    real_rows=real, visible_pairs_per_head=pairs), args
    out, args = one(32)
    out.update(plain_ms=cuda_ms(lambda: paged_attention_append_plain(*args),
                                5),
               library_ms=None, hkv8=one(8)[0])
    # a step of verify windows (VERIFY_SPECS, S 6, Hkv 32 as in the spec
    # rung's model), full tables
    c = append_case(np.random.default_rng(9), dev, 32, specs=VERIFY_SPECS,
                    S=VERIFY_S, MB=VERIFY_MB)
    args = append_args(c, c["k"], c["v"])
    out["verify_windows"] = dict(
        ms=cuda_ms(lambda: paged_attention_append(*args), 50),
        host_us_per_call=host_us(lambda: paged_attention_append(*args)),
        plain_ms=cuda_ms(lambda: paged_attention_append_plain(*args), 5),
        library_ms=None,
        **paged_sweep.append_bound(VERIFY_SPECS, 32, 32, 128),
        shape=dict(B=len(VERIFY_SPECS), S=VERIFY_S, Hq=32, Hkv=32, D=128,
                   block_size=64, MB=VERIFY_MB, lens_qlens=VERIFY_SPECS))
    return out


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)


def time_paged_quant(dev, quant):
    """B4-decode at time_paged's shape (Hkv 32, PAGED_LENS, a wiped slot),
    and at the same lens with Hkv 8 (G 4) under "hkv8": device ms, host µs
    per call, bound (``paged_sweep.decode_bound`` over the rows as stored,
    their blocks' scales and the rewritten last blocks)."""
    def one(Hkv):
        c = paged_quant_case(np.random.default_rng(14), dev, quant, Hkv)
        k, v, ks, vs = c["pools"]
        args = (c["q"], k, v, c["tables"], c["lens"], c["nk"], c["nv"])

        def call():
            return paged_attention_decode(*args, k_scale=ks, v_scale=vs,
                                          quant=quant)
        B, Hq, D = c["q"].shape
        bs, Dp = k.shape[2], k.shape[3]
        return dict(ms=cuda_ms(call, 50), host_us_per_call=host_us(call),
                    **paged_sweep.decode_bound(PAGED_LENS, Hq, Hkv, D, quant,
                                               bs, wiped=PAGED_WIPED),
                    shape=dict(B=B, Hq=Hq, Hkv=Hkv, D=D, block_size=bs,
                               payload_dim=Dp, lens=PAGED_LENS)), args, c
    out, args, c = one(32)
    ks, vs = c["pools"][2], c["pools"][3]
    out.update(plain_ms=cuda_ms(lambda: paged_attention_decode_plain(
        *args, None, ks, vs, quant), 5), library_ms=None,
        hkv8=one(8)[0])
    return out


def launch_split_ms(fn, reps, classes):
    """Device ms per call of each class of ``fn``'s kernels, traced over
    ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    br = device_breakdown(prof, wall, reps, classes)
    return None if br is None else br["device_ms_per_step_by_kernel"]


def time_append_quant(dev, quant):
    """B4-append at time_append's shape (Hkv 32, APPEND_SPECS), and with
    Hkv 8 (G 4) under "hkv8": device ms, host µs per call, bound, and the
    device ms of its two launches apart (the write pass, the attention;
    traced); bound: ``paged_sweep.append_bound`` over the history as
    stored, its blocks' scales and the rewritten window blocks."""
    def one(Hkv):
        c = append_quant_case(np.random.default_rng(15), dev, quant, Hkv)
        k, v, ks, vs = c["pools"]
        args = (c["q"], k, v, c["tables"], c["lens"], c["qlens"], c["nk"],
                c["nv"])

        def call():
            return paged_attention_append(*args, k_scale=ks, v_scale=vs,
                                          quant=quant)
        B, S, Hq, D = c["q"].shape
        bs, Dp = k.shape[2], k.shape[3]
        live = [(L, q) for L, q in APPEND_SPECS if q]
        window = sum((L + q - 1) // bs - L // bs + 1 for L, q in live)
        return dict(ms=cuda_ms(call, 50), host_us_per_call=host_us(call),
                    launches_ms=launch_split_ms(call, 20, QUANT_CLASSES),
                    **paged_sweep.append_bound(APPEND_SPECS, Hq, Hkv, D,
                                               quant, bs),
                    shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, block_size=bs,
                               payload_dim=Dp, lens_qlens=APPEND_SPECS),
                    real_rows=sum(q for _, q in live),
                    window_blocks=window), args, c
    out, args, c = one(32)
    ks, vs = c["pools"][2], c["pools"][3]
    out.update(plain_ms=cuda_ms(lambda: paged_attention_append_plain(
        *args, None, ks, vs, quant), 5), library_ms=None,
        hkv8=one(8)[0])
    return out


# ---------------------------------------------------------------------------
# B8: the weight-only int4 GEMM
# ---------------------------------------------------------------------------

#: 48: a verify window's rows at B 8, speculative_k 6 ((d-ix)'s int4 arm)
INT4_ROWS = (1, 5, 8, 16, 32, 48, 64, 127, 128)
# [n_in, n_out]: a small tile, q/k/v/o, fused q/k/v, gate/up and down at
# hidden 4096, ff 11264
INT4_SHAPES = ((2048, 512), (4096, 4096), (4096, 12288), (4096, 11264),
               (11264, 4096))
# one decoder layer's projections in the weight-only serving phase
INT4_LAYER = ((4096, 4096),) * 4 + ((4096, 11264),) * 2 + ((11264, 4096),)


def int4_weight(rng, n_in, n_out, dev):
    """A packed int4 weight and its scales, quantized on the card from a
    normal weight of std 1/sqrt(n_in) (outputs of magnitude ~1)."""
    w = torch.from_numpy((rng.standard_normal((n_in, n_out))
                          / np.sqrt(n_in)).astype(np.float32)).to(dev)
    return weight_quantize(w, algo="weight_only_int4")


def int4_tol(ref, dtype):
    """bf16: one bf16 rounding step at the output's largest magnitude;
    float32: 1e-5 of it (other fp32 summation orders)."""
    top = ref.float().abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** (np.floor(np.log2(top)) - 7)
    return 1e-5 * top


def check_int4_matmul(dev):
    """B8's launch geometry (``launch_config``) held against the kernel's
    constants (``pt_int4_matmul_check_launch``) at every INT4_SHAPES x rows
    1-128, bf16 and float32 x; then B8 against int4_matmul_plain at every
    INT4_SHAPES x INT4_ROWS, bf16 and float32 x, each within int4_tol; a
    second run gives the same bits. Returns the largest bf16 error."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    geoms = [(rows, n_in, n_out, x_bf16) for n_in, n_out in INT4_SHAPES
             for rows in range(1, 129) for x_bf16 in (True, False)]
    for g in geoms:
        i4_mod._check_launch(*g, n_sm)   # raises on a mismatch
    emit({"phase": "launch_check", "kernel": "int4_matmul",
          "geometries": len(geoms), "n_sm": n_sm})
    rng = np.random.default_rng(21)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for n_in, n_out in INT4_SHAPES:
        packed, scales = int4_weight(rng, n_in, n_out, dev)
        x_all = torch.from_numpy(rng.standard_normal((128, n_in)).astype(
            np.float32)).to(dev)
        for dtype in worst:
            errs, tols, same = [], [], True
            for rows in INT4_ROWS:
                x = x_all[:rows].to(dtype)
                out = int4_matmul(x, packed, scales)
                again = int4_matmul(x, packed, scales)
                ref = int4_matmul_plain(x, packed, scales)
                torch.cuda.synchronize()
                same = same and torch.equal(out, again)
                errs.append((out.float() - ref.float()).abs().max().item())
                tols.append(int4_tol(ref, dtype))
            emit({"phase": "parity", "kernel": "int4_matmul",
                  "shape": [n_in, n_out], "dtype": str(dtype),
                  "rows": list(INT4_ROWS), "max_abs_err": errs, "tol": tols,
                  "deterministic": same})
            require(all(e <= t for e, t in zip(errs, tols)),
                    f"int4_matmul {[n_in, n_out]} {dtype}: errors {errs} "
                    f"over {tols}")
            require(same, f"int4_matmul {[n_in, n_out]} {dtype}: two runs "
                    f"differ")
            worst[dtype] = max(worst[dtype], max(errs))
    return worst[torch.bfloat16]


def int4pack_operands(packed, scales):
    """The same function's operands for ``torch._weight_int4pack_mm``
    (timed as B8's library call, used nowhere in the port): the weight as
    its uint8 ``[n_out, n_in / 2]`` (k 2i in the high nibble, 2i + 1 in
    the low, each offset by 8) tiled by ``_convert_weight_to_int4pack``,
    and the per-channel scales repeated over groups of 256 k with zero
    points 0, in bf16 as the call takes them."""
    low, high = i4_mod.nibbles(packed)
    q = ((low.int() + 8) << 4 | (high.int() + 8)).to(torch.uint8)
    w = torch._convert_weight_to_int4pack(q.t().contiguous(), 8)
    s = scales.to(torch.bfloat16).expand(packed.shape[0] // 128, -1)
    return w, torch.stack([s, torch.zeros_like(s)], -1).contiguous()


def time_int4_matmul(dev, rows=8):
    """B8 at ``rows`` (8: a decode step; 128: the most B8 takes) on the
    four 7B-scale shapes, each launch on another
    copy of the weight so no launch finds it in the 50 MB L2 (a decode
    step reads each layer's weights once). Bound bytes: the packed weight,
    x, the scales read once and the output written once. library_ms:
    ``torch._weight_int4pack_mm`` (int4pack_operands, group 256), timed the
    same way, after its result is held within 2^-6 of the output's
    largest magnitude (its scales are rounded to bf16). bf16_gemm_ms:
    torch.matmul of the same x against a bf16 [n_in, n_out] weight (the
    unquantized layer), timed the same way. wrapper_host_us: the host's
    time per call of the wrapper (information: decode steps are paced by
    the host). The ``layer`` entry sums one decoder layer's seven
    projections (INT4_LAYER); its ``fit`` is the least-squares line of
    B8's time over the four shapes' weight bytes: a fixed cost per call
    and the rate of the rest."""
    rng = np.random.default_rng(22)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    for n_in, n_out in INT4_SHAPES[1:]:
        packed, scales = int4_weight(rng, n_in, n_out, dev)
        copies = max(2, -(-120_000_000 // packed.numel()))
        ws = [packed.clone() for _ in range(copies)]
        x = torch.from_numpy(rng.standard_normal((rows, n_in)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        it = iter(range(1 << 30))
        ms = cuda_ms(lambda: int4_matmul(x, ws[next(it) % copies], scales),
                     200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in ws * 2:
            int4_matmul(x, w, scales)
        host_us = (time.perf_counter() - t0) * 1e6 / (2 * copies)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: int4_matmul_plain(x, packed, scales), 20)
        del ws
        wl, sz = int4pack_operands(packed, scales)
        ref = int4_matmul_plain(x, packed, scales).float()
        lib_err = (torch._weight_int4pack_mm(x, wl, 256, sz).float()
                   - ref).abs().max().item()
        require(lib_err <= 2 ** -6 * ref.abs().max().item(),
                f"torch._weight_int4pack_mm {[n_in, n_out]}: error "
                f"{lib_err} against the plain version")
        wls = [wl.clone() for _ in range(copies)]
        it = iter(range(1 << 30))
        lib_ms = cuda_ms(lambda: torch._weight_int4pack_mm(
            x, wls[next(it) % copies], 256, sz), 200)
        del wls, wl
        wb = torch.from_numpy(rng.standard_normal((n_in, n_out)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        wcopies = max(2, -(-120_000_000 // (2 * wb.numel())))
        wbs = [wb.clone() for _ in range(wcopies)]
        it = iter(range(1 << 30))
        gemm_ms = cuda_ms(lambda: torch.matmul(x, wbs[next(it) % wcopies]),
                          200)
        del wbs, wb
        torch.cuda.empty_cache()
        ops = 2 * rows * n_in * n_out
        nbytes = n_in // 2 * n_out + 2 * rows * n_in + 4 * n_out \
            + 2 * rows * n_out
        res[f"{n_in}x{n_out}"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            library_max_abs_err=lib_err, bf16_gemm_ms=gemm_ms,
            wrapper_host_us=host_us,
            bf16_gemm_bound_ms=(2 * n_in * n_out + 2 * rows * n_in
                                + 2 * rows * n_out) / PEAK_BYTES * 1e3,
            splits=i4_mod.launch_config(rows, n_in, n_out, True,
                                        n_sm).splits,
            **bound(ops, nbytes))
    layer = [res[f"{a}x{b}"] for a, b in INT4_LAYER]
    res["layer"] = {k: sum(t[k] for t in layer)
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                              "bf16_gemm_ms", "wrapper_host_us", "ops",
                              "bytes")}
    slope, fixed = np.polyfit([a // 2 * b for a, b in INT4_SHAPES[1:]],
                              [res[f"{a}x{b}"]["ms"]
                               for a, b in INT4_SHAPES[1:]], 1)
    res["layer"].update(
        bound_by=layer[0]["bound_by"], rows=rows,
        shapes=[list(s) for s in INT4_LAYER],
        library="torch._weight_int4pack_mm",
        fit={"fixed_us_per_call": float(fixed) * 1e3,
             "rest_tb_per_s": 1e-9 / float(slope)})
    return res


# ---------------------------------------------------------------------------
# (d'') quantized KV served through AsyncLLMServer
# ---------------------------------------------------------------------------

SERVE_POOL_FRAC = 0.5       # the bf16 arm holds half the full block demand


@contextlib.contextmanager
def counting_plain():
    """Count calls of the plain paged versions and B8's plain version for
    the duration, by name: those the kernels' wrappers reach and those
    ``block_multihead_attention`` calls itself when the kernels do not
    take a call. On the card no part of the serving path may reach
    them."""
    calls = collections.Counter()
    targets = [(m, n) for m in (pa_mod, IF)
               for n in ("paged_attention_decode_plain",
                         "paged_attention_append_plain")]
    targets.append((i4_mod, "int4_matmul_plain"))
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    for m, n, fn in saved:
        setattr(m, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def kernel_counts():
    return {"b2_decode": paged_attention_decode.launches,
            "b3_append": paged_attention_append.launches,
            **{f"b4_decode_{q}": paged_attention_decode.quant_launches[q]
               for q in QUANTS},
            **{f"b4_append_{q}": paged_attention_append.quant_launches[q]
               for q in QUANTS}}


def reset_kernel_counts():
    int4_matmul.launches = 0
    paged_attention_decode.launches = 0
    paged_attention_append.launches = 0
    for q in QUANTS:
        paged_attention_decode.quant_launches[q] = 0
        paged_attention_append.quant_launches[q] = 0


def drift(ref_toks, arm_toks):
    """Greedy drift against the bf16 arm, per request, as the reference's
    kv-quant bench reports it: the matching prefix length, and the first
    divergent step over all requests (None: every stream equal)."""
    prefixes, first_div = [], None
    for ref, got in zip(ref_toks, arm_toks):
        n = 0
        for a, b in zip(ref, got):
            if a != b:
                break
            n += 1
        prefixes.append(n)
        if (n < min(len(ref), len(got)) or len(ref) != len(got)) and \
                (first_div is None or n < first_div):
            first_div = n
    return {"match_prefix": prefixes, "min_match_prefix": min(prefixes),
            "mean_match_prefix": float(np.mean(prefixes)),
            "first_divergence_step": first_div,
            "token_parity": first_div is None}


def serve_engine(eng, prompts, name, n_new=64, burst=False, sampling=None):
    """The requests through AsyncLLMServer (default depth) over ``eng``
    with ``n_new`` new tokens each, every step_begin under the sync watch
    on the engine thread; B8's launches are counted per step by kind.
    ``burst``: the engine takes its first request only once every request
    is submitted, so the first step finds them all queued, as if they
    arrived at one instant; thread timing otherwise decides how many ramps
    share the first steps, and so how much of a shared prompt head each
    misses, and with it whether a pressured pool preempts at all.
    ``sampling``: per prompt, the submit's sampling arguments (None: every
    request greedy).
    Gates: every request finishes with its tokens, no synchronizing call,
    no plain version, the server healthy at the end. Returns the arm's
    line (without the pool's fields) and its outputs."""
    syncs, kinds, step_ms = [], {}, {"mixed": [], "decode": []}
    b8_steps = {"mixed": collections.Counter(),
                "decode": collections.Counter()}
    clock = {"prev": None}
    begin, finish = eng.step_begin, eng.step_finish

    def watched_begin():
        f0, n8 = eng.stats["fused_steps"], int4_matmul.launches
        with sync_watch(syncs):
            pending = begin()
        if pending is not None and pending.toks is not None:
            kind = "mixed" if eng.stats["fused_steps"] > f0 else "decode"
            kinds[id(pending)] = kind
            b8_steps[kind][int4_matmul.launches - n8] += 1
        return pending

    def timed_finish(pending):
        done = finish(pending)
        now = time.perf_counter()
        kind = kinds.pop(id(pending), None)
        if kind is not None and clock["prev"] is not None:
            step_ms[kind].append((now - clock["prev"]) * 1e3)
        clock["prev"] = now
        return done

    eng.step_begin, eng.step_finish = watched_begin, timed_finish
    submitted = threading.Event()
    if burst:
        add = eng.add_request

        def gated_add(*a, **k):
            submitted.wait(60)
            return add(*a, **k)

        eng.add_request = gated_add
    server = AsyncLLMServer(eng, max_queue_size=len(prompts) + 1)
    reset_kernel_counts()
    b1 = flash_attention_fwd.launches
    with counting_plain() as plain_calls:
        server.start()
        t0 = clock["prev"] = time.perf_counter()
        handles = [server.submit(p, max_new_tokens=n_new,
                                 **(sampling[i] if sampling else {}))
                   for i, p in enumerate(prompts)]
        submitted.set()
        outs, resident = [], []
        for h in handles:
            while True:
                try:
                    outs.append(h.result(timeout=0.05))
                    break
                except TimeoutError:
                    require(time.perf_counter() - t0 < 600,
                            f"{name} arm: no progress in 600 s")
                    resident.append(sum(s is not None for s in eng.slots))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        health = server.health()
        server.stop()
    launches = kernel_counts()
    b8 = int4_matmul.launches
    b1 = flash_attention_fwd.launches - b1
    snap = server.telemetry.snapshot(wall_s=wall)
    n_mixed = eng.stats["fused_steps"]
    n_decode = eng.stats["steps"] - n_mixed
    n_tok = sum(len(o.token_ids) for o in outs)
    arm = {"arm": name, "cache_impl": eng.cache_impl,
           "pipeline_depth": server.pipeline_depth,
           "requests": len(outs), "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "preemptions": eng.stats["preemptions"],
           "mean_resident_slots": float(np.mean(resident)) if resident
           else float(eng.B),
           "mixed_steps": n_mixed, "all_decode_steps": n_decode,
           "mixed_step_ms_median": float(np.median(step_ms["mixed"]))
           if step_ms["mixed"] else None,
           "decode_step_ms_median": float(np.median(step_ms["decode"]))
           if step_ms["decode"] else None,
           "ttft_p50_s": snap["latency"]["ttft"]["p50_s"],
           "ttft_p90_s": snap["latency"]["ttft"]["p90_s"],
           "admission_stall_p50_s":
               snap["latency"]["admission_stall"]["p50_s"],
           "stage_shares": snap["attribution"],
           "launches": launches, "b8_launches": b8, "b1_launches": b1,
           "b8_launches_per_step": {k: dict(c) for k, c in b8_steps.items()},
           "plain_calls": dict(plain_calls),
           "finish_reasons": sorted({o.finish_reason for o in outs}),
           "step_begin_syncs": len(syncs),
           "step_begin_sync_messages": sorted(set(syncs))[:5],
           "healthy_at_end": health["healthy"],
           "scheduler": eng.scheduler}
    require(all(o.finished and o.finish_reason == "length" and
                len(o.token_ids) == n_new for o in outs) and
            len(outs) == len(prompts),
            f"{name} arm: a request did not finish with its "
            f"{n_new} tokens")
    require(not syncs, f"{name} arm: step_begin made "
            f"{len(syncs)} synchronizing calls")
    require(health["healthy"], f"{name} arm: server "
            f"{health['state']} at the end")
    require(not plain_calls, f"{name} arm: plain versions "
            f"ran on the card: {dict(plain_calls)}")
    # the watch wrappers close over the engine: drop them so the engine's
    # buffers are freed with it, not at the next garbage collection
    del eng.step_begin, eng.step_finish
    if burst:
        del eng.add_request
    return arm, outs


def serve_arm(model, dev, prompts, quant, n_blocks, name=None, n_new=64,
              warm=None, tier=False, burst=False, sampling=None,
              **engine_kw):
    """One paged arm: the fused engine (or another, by ``engine_kw``) over
    ``n_blocks`` pool blocks of dtype ``quant`` through
    :func:`serve_engine`; the pool invariants hold at the end, and the arm
    launches only its own paged kernels (one per layer per step of each
    kind). ``warm``: a prompt the engine first generates 2 tokens for,
    then ``reset()`` and ``reset_stats()``, as the rungs warm. ``tier``:
    the line carries the host KV tier's counters and end state (every
    block free or cached, the swap store empty). ``burst`` and
    ``sampling``: as in :func:`serve_engine`."""
    name = name or quant or "bf16"
    eng = make_fused_engine(model, dev, kv_pool_blocks=n_blocks,
                            kv_cache_dtype=quant, **engine_kw)
    if warm is not None:
        eng.generate([warm], max_new_tokens=2)
        torch.cuda.synchronize()
        eng.reset()
        eng.reset_stats()
    arm, outs = serve_engine(eng, prompts, name, n_new, burst, sampling)
    if tier:
        arm["tier"] = tier_report(eng, arm["wall_s"])
    launches = arm["launches"]
    L = model.config.num_hidden_layers
    n_mixed, n_decode = arm["mixed_steps"], arm["all_decode_steps"]
    saved_debug = eng._debug_pool
    eng._debug_pool = True
    try:
        eng._check_pool_invariants()
        invariants = True
    finally:
        eng._debug_pool = saved_debug
    arm.update({"kv_cache_dtype": quant or "bf16", "pool_blocks": n_blocks,
                "pool_bytes": eng.kv_pool_nbytes(),
                "bytes_per_block": eng.kv_bytes_per_block(),
                "effective_blocks": eng.kv_pool_effective_blocks(),
                "pool_invariants": invariants,
                "prefix": {k: eng.stats[k] for k in (
                    "prefix_hit_tokens", "prefix_cow_blocks",
                    "prefix_evicted_blocks", "prefill_tokens")}})
    dec = "b2_decode" if quant is None else f"b4_decode_{quant}"
    app = "b3_append" if quant is None else f"b4_append_{quant}"
    # the legacy scheduler prefills at admission through the static cache:
    # its steps all decode, and it never appends
    legacy = eng.scheduler == "legacy"
    require(launches[app] == n_mixed * L and (launches[app] > 0) != legacy
            and launches[dec] == n_decode * L and launches[dec] > 0,
            f"{name} arm: launches {launches} against "
            f"{n_mixed} mixed and {n_decode} all-decode steps x {L}")
    require(all(n == 0 for k, n in launches.items() if k not in (dec, app)),
            f"{name} arm: other paged kernels launched: "
            f"{launches}")
    return arm, [list(o.token_ids) for o in outs]


def profile_quant_arm(model, dev, quant, n_blocks, n_steps=4):
    """Device ms per step by kernel class in a quantized arm: a fresh fused
    engine over the arm's pool and the serving run's first eight requests;
    a window of ``n_steps`` mixed steps (during the ramp-in), then of
    all-decode steps, each untraced and then traced at depth 1 (B4-append's
    write pass and attention apart)."""
    eng = make_fused_engine(model, dev, kv_pool_blocks=n_blocks,
                            kv_cache_dtype=quant)
    for p in serving_prompts(model.config.vocab_size)[:8]:
        eng.add_request(p, max_new_tokens=64)
    run_window(eng, 2, 1)                         # warm
    res = {}
    for kind in ("mixed", "decode"):
        if kind == "decode":
            while any(s is not None and s.ramping for s in eng.slots):
                eng.step()
        want = n_steps if kind == "mixed" else 0
        wall_ms, n_mixed, _ = run_window(eng, n_steps, 1)
        require(n_mixed == want, f"{quant} profile {kind}: {n_mixed} mixed "
                f"steps of {n_steps}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, n_mixed, _ = run_window(eng, n_steps, 1)
            wall = time.perf_counter() - t0
        require(n_mixed == want, f"{quant} traced profile {kind}: {n_mixed} "
                f"mixed steps of {n_steps}")
        res[f"{kind}_depth1"] = {
            "untraced_wall_ms_per_step": wall_ms,
            "traced": device_breakdown(prof, wall, n_steps, QUANT_CLASSES)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def quant_arm_blocks(model, dev):
    """The three arms' pools at equal bytes (the reference's
    llama_serve_kv_quant sizing, bench.py:1236-1256): the bf16 arm at half
    the full block demand, each quantized arm at min(that budget // its
    bytes per block, the full demand). Returns (bytes per block, full
    demand, budget, blocks per arm)."""
    probe = {q: make_fused_engine(model, dev, kv_pool_blocks=8 + 1,
                                  kv_cache_dtype=q).kv_bytes_per_block()
             for q in (None, *QUANTS)}
    torch.cuda.empty_cache()
    full = 8 * (2048 // 64)
    budget = int(full * SERVE_POOL_FRAC) * probe[None]
    return probe, full, budget, {q: min(budget // probe[q], full)
                                 for q in (None, *QUANTS)}


def run_quant_serving(model, dev):
    """The slice's path at full width and depth: the 12 requests through
    AsyncLLMServer over the fused engine in three arms at equal pool bytes
    (quant_arm_blocks)."""
    prompts = serving_prompts(model.config.vocab_size)
    probe, full, budget, blocks = quant_arm_blocks(model, dev)
    arms, toks = {}, {}
    for q in (None, *QUANTS):
        n_blocks = blocks[q]
        arms[q or "bf16"], toks[q or "bf16"] = serve_arm(model, dev, prompts,
                                                         q, n_blocks)
        gc.collect()
        torch.cuda.empty_cache()
        if q is not None:
            arms[q]["profile"] = profile_quant_arm(model, dev, q, n_blocks)
    checked, excused, mismatched = greedy_check(
        model, dev, prompts,
        [collections.namedtuple("Out", "token_ids")(t) for t in toks["bf16"]])
    for q in QUANTS:
        arms[q]["drift_vs_bf16"] = drift(toks["bf16"], toks[q])
    emit({"phase": "quant_serving", "budget_bytes": budget,
          "full_blocks": full, "bytes_per_block": {q or "bf16": b
                                                  for q, b in probe.items()},
          "arms": arms, "bf16_greedy_checked": checked,
          "bf16_greedy_excused_near_ties": excused,
          "bf16_greedy_mismatched": mismatched, "margin": MARGIN})
    require(mismatched == 0, f"quant serving bf16 arm: {mismatched} greedy "
            f"tokens disagree with the no-cache forward beyond {MARGIN}")
    return {q: (arms[q]["launches"][f"b4_decode_{q}"],
                arms[q]["launches"][f"b4_append_{q}"]) for q in QUANTS}


def profile_quant_main(root):
    """``python3 chip_smoke.py --profile-quant ROOT``: the quantized arms'
    windows (profile_quant_arm at quant_serving's pool sizes, every kernel
    built first) of the package under ROOT (``.`` for this checkout), as
    one JSON line. One process sees one package, so compare two commits
    by alternating processes in one call (other, this, this, other)."""
    import paddle_tpu_torch
    root = os.path.abspath(root)
    require(paddle_tpu_torch.__file__.startswith(root + os.sep),
            f"--profile-quant imported {paddle_tpu_torch.__file__}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _build.build_all(KERNELS)        # no nvcc inside the windows
    model = build_model(dev)
    blocks = quant_arm_blocks(model, dev)[3]
    print(json.dumps({"root": root, "card": card_line(), **{
        q: profile_quant_arm(model, dev, q, blocks[q]) for q in QUANTS}}),
        flush=True)
    return 0


# ---------------------------------------------------------------------------
# (d-iii) weight-only int8/int4 served through AsyncLLMServer (B8)
# ---------------------------------------------------------------------------

# the reference's llama_serve rung (bench.py:724-740): Llama-2-7B widths
# with ff = hidden * 11 // 4, at which every decoder projection tiles for B8
WO_FF = 11264


def weight_bytes(model):
    """Bytes of the model's parameters on the card, and of its projections
    (Linear or WeightOnlyLinear) alone."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    proj = sum(p.numel() * p.element_size()
               for n, p in model.named_parameters()
               if "proj" in n or "lm_head" in n)
    return {"all": total, "projections": proj}


def route_gap(model, dev, prompts):
    """The largest logit gap between B8 and the split-nibble path on the
    same input: 8 sequences of 16 tokens (128 rows, the most a B8 GEMM
    takes) through a no-cache forward, FLAGS_use_pallas_int4 on then off.
    Also returns the B8 launches of the kernel run (7 per layer)."""
    ids = torch.from_numpy(np.stack([p[:16] for p in prompts[:8]])).to(dev)
    saved = get_flags("FLAGS_use_pallas_int4")
    n0 = int4_matmul.launches
    try:
        with torch.no_grad():
            on = model(ids).float()
            n_on = int4_matmul.launches - n0
            set_flags({"FLAGS_use_pallas_int4": False})
            off = model(ids).float()
    finally:
        set_flags(saved)
    return (on - off).abs().max().item(), n_on


def wo_arm(model, dev, prompts, name, margin):
    """One weight-only arm: the 12 requests through serve_arm over a bf16
    pool at the full demand, then the greedy check against a no-cache
    forward of the arm's own model, the weight bytes, and four traced
    decode steps (device ms by class: B2, B8, GEMMs, other)."""
    arm, toks = serve_arm(model, dev, prompts, None, 8 * (2048 // 64),
                          name=name)
    checked, excused, mismatched = greedy_check(
        model, dev, prompts,
        [collections.namedtuple("Out", "token_ids")(t) for t in toks],
        margin)
    arm.update(weight_bytes=weight_bytes(model), greedy_margin=margin,
               greedy_checked=checked, greedy_excused_near_ties=excused,
               greedy_mismatched=mismatched,
               decode_window=profile_decode(model, dev))
    win = arm["decode_window"]
    if win is not None:
        # one B8 kernel per call: the launch counter shows exactly 7 calls
        # a layer in each traced step of the int4 arm and none in the
        # other arms; the trace shows one kernel function and no more
        # kernels than calls (the gap: records the tracer dropped)
        calls = 7 * model.config.num_hidden_layers * win["steps"] \
            if name == "int4" else 0
        got = round(win["events_per_step_by_kernel"]["int4_gemm"]
                    * win["steps"])
        kinds = win["kernel_names_by_class"]["int4_gemm"]
        win["int4_gemm_records_dropped"] = calls - got
        require(win["int4_matmul_launches"] == calls,
                f"{name} arm: {win['int4_matmul_launches']} B8 launches in "
                f"the traced decode steps, expected {calls}")
        require(got <= calls and (got > 0) == (calls > 0)
                and len(kinds) <= 1,
                f"{name} arm: {got} int4_gemm kernels in the traced decode "
                f"steps ({sorted(kinds)}) for {calls} calls of one kernel")
    require(mismatched == 0, f"{name} arm: {mismatched} greedy tokens "
            f"disagree with its own no-cache forward beyond {margin}")
    return arm, toks


def run_weight_only_serving(model, dev):
    """The slice's path at full width and depth (the reference's
    llama_serve rung, 32 layers): the 12 requests through AsyncLLMServer
    over the fused engine with bf16 weights, then a copy quantized to
    weight-only int8, then the model itself quantized to int4 in place
    (after the int8 copy is freed), each over a bf16 KV pool at the full
    demand. The int4 arm launches B8 for every decoder projection of every
    all-decode step (8 rows) and never in a mixed step (2,048 rows); the
    other arms never. Returns the int4 arm's B8 launches."""
    t_phase = time.perf_counter()
    prompts = serving_prompts(model.config.vocab_size)
    L = model.config.num_hidden_layers
    arms, toks, swaps, gap = {}, {}, {}, None
    for name in ("bf16", "int8", "int4"):
        m = copy.deepcopy(model) if name == "int8" else model
        margin = MARGIN
        if name != "bf16":
            t0 = time.perf_counter()
            _, n = quantize_linears_for_inference(m, weight_dtype=name)
            torch.cuda.synchronize()
            swaps[name] = {"swaps": n, "seconds": time.perf_counter() - t0}
            require(n == 7 * L + 1, f"{name}: {n} swaps, expected "
                    f"{7 * L + 1}")
        if name == "int4":
            gap, n_on = route_gap(m, dev, prompts)
            require(n_on == 7 * L, f"route gap: {n_on} B8 launches in the "
                    f"kernel-route forward, expected {7 * L}")
            # an argmax flips only where top-1 minus top-2 is under twice
            # the largest logit move; doubled again since the gap is
            # sampled on one input
            margin = MARGIN + 4 * gap
        arms[name], toks[name] = wo_arm(m, dev, prompts, name, margin)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("int8", "int4"):
        arms[name]["drift_vs_bf16"] = drift(toks["bf16"], toks[name])
    emit({"phase": "weight_only_serving", "layers": L, "ff": WO_FF,
          "swaps": swaps, "route_logit_gap": gap, "arms": arms,
          "seconds": time.perf_counter() - t_phase})
    want = 7 * L
    for name, arm in arms.items():
        per = arm["b8_launches_per_step"]
        if name == "int4":
            require(set(per["decode"]) == {want} and set(per["mixed"]) == {0},
                    f"int4 arm: B8 launches per step {per}, expected "
                    f"{want} per all-decode step and 0 per mixed step")
        else:
            require(arm["b8_launches"] == 0, f"{name} arm launched B8 "
                    f"{arm['b8_launches']} times")
    return arms["int4"]["b8_launches"], arms["int4"]["greedy_margin"]


# ---------------------------------------------------------------------------
# (d-iv) generate: LlamaForCausalLM.generate, the llama_decode and
# llama_paged_decode rungs
# ---------------------------------------------------------------------------

GEN_B, GEN_PROMPT, GEN_NEW = 8, 512, 128
# bench.py's control length for the two-length differential:
# min(max(128 // 8, 8), 128 // 2)
GEN_SHORT = 16
GEN_REPS = 3
GEN_LAYERS_PAGED, GEN_KV_HEADS_PAGED = 3, 8


def gen_ids(vocab):
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, vocab, (GEN_B, GEN_PROMPT)))


def gen_differential(model, ids, cache_impl, block_size=64):
    """The rungs' two-length differential (bench.py:425-470) over the
    port's ``_gen_programs``: wall time of prefill + decode at 128 and at
    16 new tokens, the decode rate from the difference, and the prefill
    alone; medians of GEN_REPS after one warm run of each."""
    def programs(n_new):
        return model._gen_programs(GEN_B, GEN_PROMPT, n_new,
                                   GEN_PROMPT + n_new, 0.0, 0, 1.0, None,
                                   cache_impl, block_size)

    def pair(n_new):
        prefill, decode = programs(n_new)

        def run():
            logits, kb, vb = prefill(ids)
            decode(kb, vb, logits)
            torch.cuda.synchronize()
        return run

    def run_prefill():
        programs(GEN_NEW)[0](ids)
        torch.cuda.synchronize()

    def timed(fn):
        walls = []
        for _ in range(GEN_REPS):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls))

    run_long, run_short = pair(GEN_NEW), pair(GEN_SHORT)
    for fn in (run_long, run_short, run_prefill):
        fn()
    t_prefill = timed(run_prefill)
    t_short, t_long = timed(run_short), timed(run_long)
    t_decode = max(t_long - t_short, 1e-9)
    n_delta = GEN_NEW - GEN_SHORT
    return {"decode_tokens_per_s": GEN_B * n_delta / t_decode,
            "decode_ms_per_token": t_decode / n_delta * 1e3,
            "prefill_tokens_per_s": GEN_B * GEN_PROMPT / t_prefill,
            "prefill_s": t_prefill, "long_s": t_long, "short_s": t_short,
            "new_tokens_long_short": [GEN_NEW, GEN_SHORT],
            "reps": GEN_REPS}


def gen_decode_window(model, ids, cache_impl, n_steps=4):
    """Where a decode step's time goes: ``n_steps`` one-token steps of
    ``_gen_programs``' decode traced with torch.profiler after a warm
    run (device ms by kernel class, the device's idle share)."""
    prefill, decode = model._gen_programs(
        GEN_B, GEN_PROMPT, n_steps + 1, GEN_PROMPT + n_steps + 1, 0.0, 0,
        1.0, None, cache_impl, 64)
    logits, kb, vb = prefill(ids)
    decode(kb, vb, logits)             # warm
    logits, kb, vb = prefill(ids)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(kb, vb, logits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_breakdown(prof, wall, n_steps)


def gen_main_run(model, ids, cache_impl, eos=None):
    """One ``generate`` at 128 new tokens, after a warm call at the short
    length (any once-per-geometry launch check runs there): the tokens, the
    kernels' launches with their counts set to 0 just before, the plain
    versions called, and the synchronizing calls the whole call made."""
    model.generate(ids, max_new_tokens=GEN_SHORT, cache_impl=cache_impl,
                   eos_token_id=eos)
    torch.cuda.synchronize()
    reset_kernel_counts()
    flash_attention_fwd.launches = 0
    syncs = []
    with counting_plain() as plain:
        with sync_watch(syncs):
            out = model.generate(ids, max_new_tokens=GEN_NEW,
                                 cache_impl=cache_impl, eos_token_id=eos)
        torch.cuda.synchronize()
    return out.cpu().numpy(), {
        "b1_flash": flash_attention_fwd.launches,
        "b8_int4": int4_matmul.launches, **kernel_counts(),
        "plain_calls": dict(plain), "syncs": len(syncs),
        "sync_messages": sorted(set(syncs))[:5]}


def gen_greedy(model, dev, ids, toks, margin=MARGIN):
    out = collections.namedtuple("Out", "token_ids")
    return greedy_check(model, dev, ids.cpu().numpy(),
                        [out(list(t)) for t in toks], margin)


def routed_int4(model, rows):
    """The quantized projections B8 takes at ``rows`` rows."""
    return sum(1 for m in model.modules()
               if isinstance(m, WeightOnlyLinear)
               and m.weight_dtype == "int4"
               and int4_routes_to_kernel(rows, m.in_features,
                                         m.out_features, model.device))


def gen_arm_report(name, model, dev, ids, cache_impl, margin=MARGIN,
                   kernels=True):
    """An arm's main run, greedy check and differential. ``kernels``: the
    arm runs no plain paged version, which would wait on the device."""
    toks, counts = gen_main_run(model, ids, cache_impl)
    checked, excused, mismatched = gen_greedy(model, dev, ids, toks, margin)
    arm = {"arm": name, "cache_impl": cache_impl,
           "layers": model.config.num_hidden_layers,
           "kv_heads": model.config.num_key_value_heads,
           "launches": counts, "greedy_checked": checked,
           "greedy_excused_near_ties": excused,
           "greedy_mismatched": mismatched, "margin": margin,
           **gen_differential(model, ids, cache_impl),
           "decode_window": gen_decode_window(model, ids, cache_impl)}
    L = model.config.num_hidden_layers
    require(toks.shape == (GEN_B, GEN_NEW), f"generate {name}: tokens of "
            f"shape {toks.shape}")
    require(counts["b1_flash"] == L, f"generate {name}: {counts['b1_flash']}"
            f" flash launches in the prefill, expected {L}")
    require(counts["syncs"] == 0 or not kernels, f"generate {name}: "
            f"{counts['syncs']} synchronizing calls without an eos id")
    require(mismatched == 0, f"generate {name}: {mismatched} tokens disagree "
            f"with the no-cache forward beyond the {margin} margin")
    return arm, toks


def run_generate(model, dev):
    """The llama_decode rung on the smoke's 32-layer model (static cache:
    B1 in the prefill, masked plain attention in the decode, as the
    reference), then the llama_paged_decode rung on its 3-layer GQA model,
    B2 in the decode, against the static cache of the same model and the
    plain paged versions (use_paged_attention off)."""
    t_phase = time.perf_counter()
    ids = gen_ids(model.config.vocab_size).to(dev)
    arms = {}
    arms["static"], static_toks = gen_arm_report("static", model, dev, ids,
                                                 "static")
    c = arms["static"]["launches"]
    require(not c["plain_calls"] and all(
        c[k] == 0 for k in ("b8_int4", *kernel_counts())),
        f"generate static: other kernels or plain versions ran: {c}")
    # an eos id a row emits mid-run: the decode reads the device once a
    # window; each row's tokens up to its first eos are the free run's
    eos = int(static_toks[0, GEN_NEW // 2])
    eos_toks, eos_counts = gen_main_run(model, ids, "static", eos=eos)
    windows = -(-GEN_NEW // GEN_WINDOW)
    rows_ok = True
    for free, got in zip(static_toks, eos_toks):
        hits = np.nonzero(free == eos)[0]
        cut = int(hits[0]) + 1 if len(hits) else GEN_NEW
        rows_ok &= bool((got[:min(cut, len(got))] == free[:min(cut, len(got))]
                         ).all() and (got[cut:] == eos).all())
    arms["static_eos"] = {"eos_token_id": eos, "n": int(eos_toks.shape[1]),
                          "syncs": eos_counts["syncs"],
                          "windows": windows, "rows_match": rows_ok}
    require(eos_counts["syncs"] <= windows and rows_ok,
            f"generate static with eos: {arms['static_eos']}")
    gc.collect()
    torch.cuda.empty_cache()

    paged = build_model(dev, num_hidden_layers=GEN_LAYERS_PAGED,
                        num_key_value_heads=GEN_KV_HEADS_PAGED)
    L = GEN_LAYERS_PAGED
    ref_toks, _ = gen_main_run(paged, ids, "static")
    arms["paged"], paged_toks = gen_arm_report("paged", paged, dev, ids,
                                               "paged")
    c = arms["paged"]["launches"]
    steps = GEN_NEW - 1
    require(c["b2_decode"] == L * steps and not c["plain_calls"] and all(
        c[k] == 0 for k in c if k.startswith(("b3", "b4", "b8"))),
        f"generate paged: launches {c}, expected {L * steps} B2 "
        f"({L} layers x {steps} one-token steps) and nothing else")
    arms["paged"]["drift_vs_static"] = drift(ref_toks.tolist(),
                                             paged_toks.tolist())
    saved = get_flags("FLAGS_use_paged_attention")
    try:
        set_flags({"FLAGS_use_paged_attention": False})
        arms["paged_plain"], plain_toks = gen_arm_report(
            "paged_plain", paged, dev, ids, "paged", kernels=False)
    finally:
        set_flags(saved)
    c = arms["paged_plain"]["launches"]
    require(c["b2_decode"] == 0 and
            c["plain_calls"].get("paged_attention_decode_plain", 0)
            == L * steps,
            f"generate paged, kernel off: launches {c}, expected no B2 and "
            f"{L * steps} plain decode calls")
    arms["paged_plain"]["drift_vs_kernel"] = drift(paged_toks.tolist(),
                                                   plain_toks.tolist())
    arms["paged"]["kernel_speedup"] = \
        arms["paged"]["decode_tokens_per_s"] / \
        arms["paged_plain"]["decode_tokens_per_s"]
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "generate", "batch": GEN_B, "prompt": GEN_PROMPT,
          "new_tokens": GEN_NEW, "window": GEN_WINDOW, "arms": arms,
          "seconds": time.perf_counter() - t_phase})
    return {"b1": arms["static"]["launches"]["b1_flash"]
            + arms["paged"]["launches"]["b1_flash"]
            + arms["paged_plain"]["launches"]["b1_flash"],
            "b2": arms["paged"]["launches"]["b2_decode"]}


def run_generate_int4(model, dev, margin):
    """The llama_decode rung with int4 weights, on the weight_only_serving
    model after its int4 arm: B8 in every decode step (8 rows) for each
    projection it takes, the split-nibble route in the prefill (4,096
    rows); tokens under the int4 arm's widened margin."""
    t_phase = time.perf_counter()
    ids = gen_ids(model.config.vocab_size).to(dev)
    arm, _ = gen_arm_report("int4", model, dev, ids, "static", margin)
    c = arm["launches"]
    per_step = routed_int4(model, GEN_B)
    want = per_step * (GEN_NEW - 1)
    arm["b8_projections_per_step"] = per_step
    emit({"phase": "generate_int4", "batch": GEN_B, "prompt": GEN_PROMPT,
          "new_tokens": GEN_NEW, "ff": model.config.intermediate_size,
          "arm": arm, "seconds": time.perf_counter() - t_phase})
    require(per_step > 0 and c["b8_int4"] == want and
            routed_int4(model, GEN_B * GEN_PROMPT) == 0 and
            not c["plain_calls"],
            f"generate int4: {c['b8_int4']} B8 launches, expected {want} "
            f"({per_step} projections x {GEN_NEW - 1} steps); plain calls "
            f"{c['plain_calls']}")
    return {"b1": c["b1_flash"], "b8": c["b8_int4"]}


# ---------------------------------------------------------------------------
# (d-v) prefix cache: the llama_serve_prefix_cache rung
# ---------------------------------------------------------------------------

PC_REQUESTS, PC_SYS, PC_TAIL, PC_NEW = 16, 256, 128, 64
# the rung's capacity: the longest prompt plus its tokens, in chunks of 256
PC_CAP = -(-(PC_SYS + PC_TAIL + PC_NEW) // 256) * 256


def prefix_prompts(vocab):
    """The rung's traffic (bench.py:1117-1122): a shared 256-token system
    prompt before tails of 64-127 tokens, and all-unique prompts of the
    same lengths."""
    rng = np.random.default_rng(6)
    sys_prompt = rng.integers(0, vocab, (PC_SYS,)).astype(np.int32)
    tails = [rng.integers(0, vocab, (PC_TAIL // 2 + int(x),)).astype(
        np.int32) for x in rng.integers(0, PC_TAIL // 2, size=PC_REQUESTS)]
    shared = [np.concatenate([sys_prompt, t]) for t in tails]
    unique = [rng.integers(0, vocab, (PC_SYS + len(t),)).astype(np.int32)
              for t in tails]
    return shared, unique


def margin_run(model, dev, prompts, quant=None):
    """A cache-off reference served step by step (no server, depth 1):
    each request's tokens and, per token, the top-1/top-2 margin of the
    logits it was sampled from (the engine's carried logits after the step
    before it)."""
    eng = make_fused_engine(model, dev, max_seq_len=PC_CAP,
                            kv_cache_dtype=quant)
    rids = [eng.add_request(p, max_new_tokens=PC_NEW) for p in prompts]
    gaps = {r: {} for r in rids}
    while eng.has_unfinished():
        eng.step()
        top2 = torch.topk(eng._logits, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        for b, slot in enumerate(eng.slots):
            if slot is not None and not slot.ramping:
                gaps[slot.req.request_id][len(slot.generated)] = \
                    float(gap[b])
    toks = [list(eng.finished_outputs.pop(r).token_ids) for r in rids]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, [gaps[r] for r in rids]


def against_reference(ref, ref_gaps, toks):
    """Each stream against the reference's up to its first difference:
    the streams that differ and the reference's margin there (a
    divergence where it exceeds MARGIN is a fault)."""
    at = []
    for want, gaps, got in zip(ref, ref_gaps, toks):
        i = next((k for k, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if i is None and len(want) == len(got):
            continue
        i = min(len(want), len(got)) if i is None else i
        at.append({"step": i, "margin": gaps.get(i, float("inf"))})
    return {"diverged": len(at), "faults": sum(d["margin"] > MARGIN
                                               for d in at),
            "divergences": at}


def hit_rate(arm):
    hit = arm["prefix"]["prefix_hit_tokens"]
    pre = arm["prefix"]["prefill_tokens"]
    return hit / (hit + pre) if hit + pre else 0.0


def run_prefix_cache(model, dev):
    """The llama_serve_prefix_cache rung's traffic on the smoke's 32-layer
    model: 16 requests through AsyncLLMServer over the fused engine (8
    slots, chunk 256, block 64), shared and unique prompts with the cache
    on and off, the shared ones again under the legacy scheduler and over
    an int8 pool, every engine auditing its pool after each operation."""
    t_phase = time.perf_counter()
    saved_env = os.environ.get("PADDLE_TPU_POOL_CHECKS")
    os.environ["PADDLE_TPU_POOL_CHECKS"] = "1"
    try:
        shared, unique = prefix_prompts(model.config.vocab_size)
        refs = {"shared": margin_run(model, dev, shared),
                "unique": margin_run(model, dev, unique),
                "shared_int8": margin_run(model, dev, shared, "int8")}
        arms = {}
        for name, prompts, ref, quant, kw in (
                ("shared_on", shared, "shared", None,
                 dict(enable_prefix_cache=True)),
                ("shared_off", shared, "shared", None, {}),
                ("unique_on", unique, "unique", None,
                 dict(enable_prefix_cache=True)),
                ("unique_off", unique, "unique", None, {}),
                ("shared_on_legacy", shared, "shared", None,
                 dict(enable_prefix_cache=True, scheduler="legacy")),
                ("shared_on_int8", shared, "shared_int8", "int8",
                 dict(enable_prefix_cache=True))):
            arm, toks = serve_arm(model, dev, prompts, quant,
                                  8 * (PC_CAP // 64), name=name,
                                  n_new=PC_NEW, max_seq_len=PC_CAP, **kw)
            arm["hit_rate"] = hit_rate(arm)
            arm["against_cache_off"] = against_reference(*refs[ref], toks)
            arms[name] = arm
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if saved_env is None:
            os.environ.pop("PADDLE_TPU_POOL_CHECKS", None)
        else:
            os.environ["PADDLE_TPU_POOL_CHECKS"] = saved_env
    overhead = (1.0 - arms["unique_on"]["tokens_per_s"]
                / arms["unique_off"]["tokens_per_s"]) * 100
    emit({"phase": "prefix_cache", "requests": PC_REQUESTS,
          "system_prompt": PC_SYS, "tails": [PC_TAIL // 2, PC_TAIL - 1],
          "new_tokens": PC_NEW, "capacity": PC_CAP, "arms": arms,
          "speedup_shared": arms["shared_on"]["tokens_per_s"]
          / arms["shared_off"]["tokens_per_s"],
          "unique_overhead_pct": overhead, "margin": MARGIN,
          "seconds": time.perf_counter() - t_phase})
    for name, arm in arms.items():
        cache_on = name.endswith(("_on", "_legacy", "_int8"))
        require(arm["pool_invariants"], f"prefix {name}: pool audit")
        require(arm["against_cache_off"]["faults"] == 0,
                f"prefix {name}: a stream leaves its cache-off reference "
                f"where the margin exceeds {MARGIN}: "
                f"{arm['against_cache_off']['divergences']}")
        if name.startswith("shared") and cache_on:
            require(arm["hit_rate"] > 0, f"prefix {name}: no hit")
        else:
            require(arm["hit_rate"] == 0.0, f"prefix {name}: hit rate "
                    f"{arm['hit_rate']} where nothing is shared or cached")
    total = collections.Counter()
    for arm in arms.values():
        total.update(arm["launches"])
    return dict(total)


# ---------------------------------------------------------------------------
# (d-vi) the dense engine: the llama_serve_fused rung's traffic
# ---------------------------------------------------------------------------

#: the rung's model and traffic (bench.py:967-1010): 7B widths with ff
#: hidden * 11 // 4, 3 layers, MHA, bf16, seed 0; 8 slots, capacity 512 +
#: 64, chunk 256, horizon 64; 16 requests of 256-511 tokens, 64 new each
DENSE_LAYERS, DENSE_FF, DENSE_SLOTS = 3, 11264, 8
DENSE_REQUESTS, DENSE_NEW, DENSE_CHUNK, DENSE_HORIZON = 16, 64, 256, 64
DENSE_CAP = 512 + DENSE_NEW
#: the paged comparison arm's capacity: paged KV needs a multiple of the
#: chunk (its rope table is the model's; the prompts never reach it)
DENSE_PAGED_CAP = 768


def dense_prompts(vocab):
    """The rung's prompts: 256 + U[0, 256) tokens of uniform ids."""
    rng = np.random.default_rng(0)
    lens = [256 + int(x) for x in rng.integers(0, 256, size=DENSE_REQUESTS)]
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def rung_engine(model, dev, scheduler, **over):
    """The rung's engine: ``LLMEngine(model)`` with the rung's arguments,
    so dense unless ``over`` says otherwise."""
    return LLMEngine(model, **{**dict(
        max_batch=DENSE_SLOTS, max_seq_len=DENSE_CAP, chunk_size=DENSE_CHUNK,
        horizon=DENSE_HORIZON, scheduler=scheduler, device=dev), **over})


def dense_arm(model, dev, prompts, name, eng, warm=True):
    """One arm of (d-vi): ``eng`` warmed as the rung warms it (one request
    of 2 tokens, then the stats reset), the requests through
    :func:`serve_engine`, then the greedy check against the model's
    no-cache forward. Returns the arm's line and its tokens."""
    if warm:
        eng.generate([prompts[0]], max_new_tokens=2)
        torch.cuda.synchronize()
        eng.reset_stats()
    arm, outs = serve_engine(eng, prompts, name, DENSE_NEW)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    checked, excused, mismatched = greedy_check(model, dev, prompts, outs)
    arm.update(greedy_checked=checked, greedy_excused_near_ties=excused,
               greedy_mismatched=mismatched)
    return arm, [list(o.token_ids) for o in outs]


def profile_dense(model, dev, prompts, n_mixed=4):
    """Where a dense fused step's time goes: the rung's first eight
    requests in a fresh dense fused engine, ``n_mixed`` mixed steps
    during the ramp-in and then one all-decode step (``horizon`` tokens a
    slot), each traced at depth 1: device busy, idle share, products and
    the rest."""
    eng = rung_engine(model, dev, "fused")
    for p in prompts[:8]:
        eng.add_request(p, max_new_tokens=DENSE_NEW)
    run_window(eng, 2, 1)                         # warm
    res = {}
    for kind, n in (("mixed", n_mixed), ("decode", 1)):
        if kind == "decode":
            while any(s is not None and s.ramping for s in eng.slots):
                eng.step()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, got, _ = run_window(eng, n, 1)
            wall = time.perf_counter() - t0
        require(got == (n if kind == "mixed" else 0),
                f"dense profile {kind}: {got} mixed steps of {n}")
        res[kind] = device_breakdown(prof, wall, n)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_dense_serving(model, dev, fused_tokens):
    """(d-vi): the dense engine, the reference's default. First the
    smoke's 32-layer model serves phase (d)'s 12 requests through a dense
    fused engine (capacity 2,048); then the llama_serve_fused rung's model
    serves the rung's 16 requests through AsyncLLMServer over
    ``LLMEngine(model)`` with the fused and then the legacy scheduler, and
    over the paged fused engine for a comparison within this run. Gates:
    every request finishes with its 64 tokens, no flash, paged or int4
    kernel launches and no plain version is reached in a dense arm, no
    synchronizing call in a step_begin, the server healthy at the end, and
    every token the no-cache argmax where the top-2 margin exceeds 0.05.
    Returns the paged arm's kernel launches."""
    t_phase = time.perf_counter()
    prompts32 = serving_prompts(model.config.vocab_size)
    arms = {}
    arms["dense_fused_32_layers"], toks32 = dense_arm(
        model, dev, prompts32, "dense_fused_32_layers",
        LLMEngine(model, max_batch=8, chunk_size=256, max_seq_len=2048,
                  scheduler="fused", device=dev), warm=False)
    same = sum(int(a == b) for got, ref in zip(toks32, fused_tokens)
               for a, b in zip(got, ref))
    arms["dense_fused_32_layers"].update(
        tokens_equal_to_fused_phase=same,
        first_divergence=drift(fused_tokens, toks32)["first_divergence_step"])
    rung = build_model(dev, num_hidden_layers=DENSE_LAYERS,
                       intermediate_size=DENSE_FF,
                       max_position_embeddings=DENSE_PAGED_CAP)
    prompts = dense_prompts(rung.config.vocab_size)
    toks = {}
    for name, scheduler, over in (
            ("dense_fused", "fused", {}), ("dense_legacy", "legacy", {}),
            ("paged_fused", "fused", dict(cache_impl="paged", block_size=64,
                                          max_seq_len=DENSE_PAGED_CAP))):
        arms[name], toks[name] = dense_arm(
            rung, dev, prompts, name,
            rung_engine(rung, dev, scheduler, **over))
    profile_win = profile_dense(rung, dev, prompts)
    del rung
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("dense_legacy", "paged_fused"):
        arms[name]["drift_vs_dense_fused"] = drift(toks["dense_fused"],
                                                   toks[name])
    emit({"phase": "dense_serving", "layers": DENSE_LAYERS, "ff": DENSE_FF,
          "slots": DENSE_SLOTS, "capacity": DENSE_CAP, "chunk": DENSE_CHUNK,
          "horizon": DENSE_HORIZON, "requests": len(prompts),
          "prompt_lens": [len(p) for p in prompts], "new_tokens": DENSE_NEW,
          "paged_capacity": DENSE_PAGED_CAP,
          "scheduler_speedup": arms["dense_fused"]["tokens_per_s"]
          / arms["dense_legacy"]["tokens_per_s"],
          "paged_over_dense_fused": arms["paged_fused"]["tokens_per_s"]
          / arms["dense_fused"]["tokens_per_s"],
          "arms": arms, "profile": profile_win, "margin": MARGIN,
          "seconds": time.perf_counter() - t_phase})
    for name, arm in arms.items():
        if arm["cache_impl"] == "dense":
            require(all(n == 0 for n in arm["launches"].values())
                    and arm["b8_launches"] == 0 and arm["b1_launches"] == 0,
                    f"dense {name}: kernels launched: {arm['launches']}, "
                    f"B8 {arm['b8_launches']}, B1 {arm['b1_launches']}")
        require(arm["greedy_mismatched"] == 0,
                f"dense {name}: {arm['greedy_mismatched']} greedy tokens "
                f"disagree with the no-cache forward beyond {MARGIN}")
    paged = arms["paged_fused"]["launches"]
    require(paged["b2_decode"] > 0 and paged["b3_append"] > 0,
            f"dense phase's paged arm: launches {paged}")
    return paged


# ---------------------------------------------------------------------------
# (d-vii) serve_rung: the llama_serve rung's path (bench.py:709-966)
# ---------------------------------------------------------------------------

#: the rung's multi-step A/B stride (its BENCH_READOUT_STRIDE default)
RUNG_STRIDE = 8
#: each on/off A/B takes the median of this many passes a side
RUNG_REPS = 3


@contextlib.contextmanager
def window_watch(eng, log):
    """CUDA's sync debug mode over a whole serve, every thread: each
    synchronizing call is attributed to where the engine was, in
    ``step_begin``, in ``step_finish`` (whose wait on its step's event is
    the readout itself, and a CUDA event wait is not flagged), or
    elsewhere. Also logs each dispatch (kind, token rows, resident slots),
    the finish-to-finish ms by kind, the recorder the server attached, and
    the kernels' launch counts over the serve (reset on entry)."""
    log.update(begin=0, finish=0, elsewhere=0, finishes=0, dispatches=[],
               resident=[], step_ms={"mixed": [], "decode": [], "spec": []},
               messages=[], recorder=None)
    begin, finish = eng.step_begin, eng.step_finish
    kinds, clock = {}, {"prev": None}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")

            def n_syncs():
                return sum("synchroniz" in str(w.message) for w in caught)

            def watched_begin():
                n0 = n_syncs()
                pending = begin()
                log["begin"] += n_syncs() - n0
                log["recorder"] = eng.flight_recorder
                if pending is not None and pending.toks is not None:
                    # "decode", "mixed" or "spec" (verify windows); the
                    # rows are a spec dispatch's windows
                    kind = pending.kind
                    kinds[id(pending)] = kind
                    log["dispatches"].append((kind,
                                              int(pending.toks.shape[0])))
                    log["resident"].append(
                        sum(s is not None for s in eng.slots))
                return pending

            def watched_finish(pending):
                n0 = n_syncs()
                done = finish(pending)
                log["finish"] += n_syncs() - n0
                log["finishes"] += 1
                now = time.perf_counter()
                kind = kinds.pop(id(pending), None)
                if kind is not None and clock["prev"] is not None:
                    log["step_ms"][kind].append((now - clock["prev"]) * 1e3)
                clock["prev"] = now
                return done

            eng.step_begin, eng.step_finish = watched_begin, watched_finish
            reset_kernel_counts()
            b1, b8 = flash_attention_fwd.launches, int4_matmul.launches
            clock["prev"] = time.perf_counter()
            try:
                yield log
            finally:
                del eng.step_begin, eng.step_finish
                log["launches"] = kernel_counts()
                log["b1_launches"] = flash_attention_fwd.launches - b1
                log["b8_launches"] = int4_matmul.launches - b8
                msgs = [str(w.message) for w in caught
                        if "synchroniz" in str(w.message)]
                log["elsewhere"] = len(msgs) - log["begin"] - log["finish"]
                log["messages"] = sorted(set(msgs))[:5]
    finally:
        torch.cuda.set_sync_debug_mode("default")


def window_gates(name, log, stride=None, spec_k=1):
    """The sync gates of one watched serve: no synchronizing call in a
    ``step_begin`` or between the loop's steps, and none in a
    ``step_finish`` beyond its readout; and, with the recorder the server
    attached, each StepRecord's ``readout_stride`` against its dispatch:
    a mixed step ``spec_k`` (1 without speculation), an all-decode step
    ``stride`` with at most that many rows read back (``stride`` None: the
    engine's ``horizon``, exactly), a speculative all-decode step ``spec_k
    * stride`` with at most ``stride`` windows."""
    require(log["begin"] == 0 and log["elsewhere"] == 0
            and log["finish"] <= log["finishes"],
            f"{name}: synchronizing calls in step_begin {log['begin']}, "
            f"in step_finish {log['finish']} of {log['finishes']} "
            f"readouts, elsewhere {log['elsewhere']}: {log['messages']}")
    rec = log["recorder"]
    if rec is None:
        return
    recs = [r for r in rec.records() if r.kind != "drain"]
    require(len(recs) == len(log["dispatches"]),
            f"{name}: {len(recs)} step records for "
            f"{len(log['dispatches'])} dispatches")
    for r, (kind, rows) in zip(recs, log["dispatches"]):
        if kind == "spec":
            want, most = spec_k * stride, stride
        else:
            want = spec_k if kind == "mixed" else (stride or rows)
            most = want
        require(r.kind == kind and r.readout_stride == want
                and 1 <= rows <= most,
                f"{name}: step {r.step_id} recorded {r.kind} at stride "
                f"{r.readout_stride}, dispatched {kind} with {rows} rows")


def rung_pass(eng, prompts, name, **server_kw):
    """One pass of the rung's protocol: the requests through a fresh
    AsyncLLMServer over ``eng`` with ``server_kw``, the whole serve
    watched; every request must finish with its 64 tokens and the server
    be healthy at the end. Returns the pass's line and its tokens."""
    log = {}
    srv = AsyncLLMServer(eng, max_queue_size=len(prompts) + 1, **server_kw)
    with window_watch(eng, log):
        srv.start()
        t0 = time.perf_counter()
        handles = [srv.submit(p, max_new_tokens=DENSE_NEW) for p in prompts]
        outs = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        health = srv.health()
        srv.stop()
    n_tok = sum(len(o.token_ids) for o in outs)
    require(all(o.finished and o.finish_reason == "length"
                and len(o.token_ids) == DENSE_NEW for o in outs),
            f"{name}: a request did not finish with its {DENSE_NEW} tokens")
    require(health["healthy"], f"{name}: server {health['state']} at the end")
    window_gates(name, log)
    return {"name": name, "tokens_per_s": n_tok / wall, "wall_s": wall,
            "server": srv, "log": log, "outs": outs,
            "tokens": [list(o.token_ids) for o in outs]}


def median(xs):
    return sorted(xs)[len(xs) // 2]


def overhead_pct(off, on):
    return (median(off) - median(on)) / median(off) * 100


def profile_stride(rung, dev, prompts, n_steps=2):
    """Where a stride-8 all-decode step's time goes: the rung's first
    eight requests in a fresh dense fused engine at ``readout_stride=8``,
    ramped in and one stride warmed, then ``n_steps`` strides traced at
    depth 1."""
    eng = LLMEngine(rung, max_batch=DENSE_SLOTS, max_seq_len=DENSE_CAP,
                    chunk_size=DENSE_CHUNK, scheduler="fused",
                    readout_stride=RUNG_STRIDE, device=dev)
    for p in prompts[:8]:
        eng.add_request(p, max_new_tokens=DENSE_NEW)
    eng.step()                      # admission assigns the slots
    while any(s is not None and s.ramping for s in eng.slots):
        eng.step()
    run_window(eng, 1, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, mixed, begin_ms = run_window(eng, n_steps, 1)
        wall = time.perf_counter() - t0
    require(mixed == 0, f"stride profile: {mixed} mixed steps")
    win = device_breakdown(prof, wall, n_steps)
    if win is not None:
        win["step_begin_host_ms"] = begin_ms
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return win


class _Out:
    """A token list in the shape :func:`greedy_check` reads."""

    def __init__(self, token_ids):
        self.token_ids = token_ids


def one_wave(model, dev, prompts, **engine_kw):
    """At most one request a slot (no re-admission) through fused engines
    at ``readout_stride`` 1 and 8, straight from ``generate``: every token
    takes the same kind of step in both, so the streams must be equal bit
    for bit (the stride's iterations run the single step's math). Returns
    whether they are and the stride arm's multi-step dispatches."""
    toks, multi = {}, 0
    for stride in (1, RUNG_STRIDE):
        eng = LLMEngine(model, scheduler="fused", readout_stride=stride,
                        device=dev, **engine_kw)
        toks[stride] = [list(o.token_ids) for o in eng.generate(
            prompts, max_new_tokens=64)]
        multi = eng.stats["multi_steps"]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return toks[1] == toks[RUNG_STRIDE], multi


def arm_greedy(model, dev, prompts, streams, name):
    """Each arm's tokens against the model's no-cache forward: two arms
    that both pass agree up to their first near-tie, since up to there
    they share the prefix the forward reads."""
    res = {}
    for arm, toks in streams.items():
        checked, excused, mismatched = greedy_check(
            model, dev, prompts, [_Out(t) for t in toks])
        res[arm] = {"checked": checked, "excused_near_ties": excused,
                    "mismatched": mismatched}
        require(mismatched == 0, f"{name} {arm} arm: {mismatched} greedy "
                f"tokens disagree with the no-cache forward beyond {MARGIN}")
    return res


def stride_pair_32(model, dev):
    """The 32-layer model serves phase (d)'s 12 requests through paged
    fused engines (8 slots, block 64, chunk 256, capacity 2,048) at
    ``readout_stride=8`` and 1, each arm's serve watched. Gates: one wave
    of 8 requests token-exact across the strides (:func:`one_wave`), both
    arms of the full traffic through the greedy check (so they agree up
    to near-ties), multi-step dispatches in the stride arm only and fewer
    round trips there, B2 launched once a layer for every decode
    iteration and B3 once a layer a mixed step, the sync and record
    gates. Returns the pair's line."""
    prompts = serving_prompts(model.config.vocab_size)
    paged = dict(cache_impl="paged", block_size=64, max_batch=8,
                 max_seq_len=2048, chunk_size=256)
    wave_exact, wave_multi = one_wave(model, dev, prompts[:8], **paged)
    require(wave_exact and wave_multi > 0,
            f"32-layer one wave: strides 1 and {RUNG_STRIDE} differ "
            f"(exact {wave_exact}, multi-steps {wave_multi})")
    logs, arms, toks = {"off": {}, "on": {}}, {}, {}
    L = model.config.num_hidden_layers
    for arm, stride in (("off", 1), ("on", RUNG_STRIDE)):
        def watch(eng, arm=arm):
            return window_watch(eng, logs[arm])

        arms[arm], toks[arm] = serve_stride_arm(
            model, prompts, 64, 8, 2048, stride, chunk_size=256,
            timeout=600, device=dev,
            engine_kw=dict(cache_impl="paged", block_size=64), watch=watch)
        gc.collect()
        torch.cuda.empty_cache()
        log = logs[arm]
        window_gates(f"32-layer stride {stride}", log, stride)
        iters = sum(r for k, r in log["dispatches"] if k == "decode")
        n_mixed = sum(k == "mixed" for k, _ in log["dispatches"])
        got = log["launches"]
        require(got["b2_decode"] == iters * L and
                got["b3_append"] == n_mixed * L and
                got["b2_decode"] > 0 and log["b8_launches"] == 0,
                f"32-layer stride {stride}: launches {got} for {iters} "
                f"decode iterations and {n_mixed} mixed steps a layer")
        arms[arm].update(
            decode_iterations=iters, mixed_steps=n_mixed,
            launches=got, step_begin_syncs=log["begin"],
            step_finish_syncs=log["finish"],
            decode_step_ms_median=median(log["step_ms"]["decode"])
            if log["step_ms"]["decode"] else None,
            mixed_step_ms_median=median(log["step_ms"]["mixed"])
            if log["step_ms"]["mixed"] else None)
    on, off = arms["on"], arms["off"]
    require(on["multi_steps"] > 0 and off["multi_steps"] == 0 and
            on["host_round_trips"] < off["host_round_trips"],
            f"32-layer stride pair: multi-steps {on['multi_steps']} / "
            f"{off['multi_steps']}, round trips {on['host_round_trips']} / "
            f"{off['host_round_trips']}")
    greedy = arm_greedy(model, dev, prompts, toks, "32-layer stride pair")
    return {"arms": arms, "speedup": on["tokens_per_sec"]
            / off["tokens_per_sec"], "one_wave_exact": wave_exact,
            "one_wave_multi_steps": wave_multi,
            "drift": drift(toks["off"], toks["on"]), "greedy": greedy,
            "b2_launches": on["launches"]["b2_decode"]
            + off["launches"]["b2_decode"],
            "b3_launches": on["launches"]["b3_append"]
            + off["launches"]["b3_append"]}


def run_serve_rung(model, dev):
    """(d-vii): the llama_serve rung. Its model (7B widths, ff 11264, 3
    layers, MHA, bf16, seed 0) and 16 requests (256-511 tokens, 64 new)
    through AsyncLLMServer over ``LLMEngine(model, max_batch=8,
    max_seq_len=576, chunk_size=256, horizon=64)`` (dense, legacy) in the
    rung's passes: a plain pass, then flight recorder on against off,
    supervision against off, the metrics store against off and trace
    contexts off against on, each side the median of three alternating
    passes; the recorder's chrome trace (to a temporary directory), p99
    tail and snapshot; then the multi-step A/B through
    ``tools/multi_step_ab.py`` (dense fused engines at readout_stride 8
    against 1), a few traced stride-8 steps, and the 32-layer model's
    stride pair (:func:`stride_pair_32`). Gates: every request finishes
    with its 64 tokens in every pass and arm, every pass's streams equal
    the plain pass's, one wave of the A/B's engines token-exact
    (:func:`one_wave`) and both served arms through the greedy check,
    multi-step dispatches and fewer round trips in the stride arm, no
    kernel and no counted plain version in a dense arm, the sync and
    record gates of :func:`window_gates`, the server healthy, the greedy
    check on the plain pass. Returns the 32-layer pair's B2 and B3
    launches."""
    t_phase = time.perf_counter()
    rung = build_model(dev, num_hidden_layers=DENSE_LAYERS,
                       intermediate_size=DENSE_FF,
                       max_position_embeddings=DENSE_CAP)
    prompts = dense_prompts(rung.config.vocab_size)
    eng = rung_engine(rung, dev, "legacy")
    with counting_plain() as plain_calls:
        eng.generate([prompts[0]], max_new_tokens=2)   # warm
        torch.cuda.synchronize()
        rtts = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(eng._logits[0, 0])
            rtts.append(time.perf_counter() - t0)
        rtt = median(rtts)
        eng.reset_stats()
        passes = []

        def run(name, **kw):
            res = rung_pass(eng, prompts, name, **kw)
            passes.append(res)
            return res

        plain = run("plain")
        stats_plain = dict(eng.stats)
        on_tps, off_tps = [], [plain["tokens_per_s"]]
        recorder = server_on = None
        for i in range(RUNG_REPS):
            recorder = FlightRecorder()
            res = run(f"recorder_on_{i}", flight_recorder=recorder)
            on_tps.append(res["tokens_per_s"])
            server_on, wall_on = res["server"], res["wall_s"]
            if len(off_tps) < RUNG_REPS:
                off_tps.append(run(f"recorder_off_{i}")["tokens_per_s"])
        sup_on, sup_off, ms_on, ms_off, tc_on, tc_off = ([] for _ in range(6))
        for i in range(RUNG_REPS):
            sup_on.append(run(f"supervised_{i}", supervise=RestartPolicy(),
                              step_timeout_s=300.0)["tokens_per_s"])
            sup_off.append(run(f"unsupervised_{i}")["tokens_per_s"])
        store_series = 0
        for i in range(RUNG_REPS):
            res = run(f"metrics_store_{i}", metrics_store=True)
            ms_on.append(res["tokens_per_s"])
            store_series = len(res["server"].metrics_store.snapshot()
                               ["series"])
            ms_off.append(run(f"no_metrics_store_{i}")["tokens_per_s"])
        for i in range(RUNG_REPS):
            tc_on.append(run(f"trace_context_{i}")["tokens_per_s"])
            tc_off.append(run(f"no_trace_context_{i}",
                              trace_context=False)["tokens_per_s"])
        with tempfile.TemporaryDirectory() as tmp:
            trace_path = recorder.export_chrome_trace(
                os.path.join(tmp, "llama_serve_trace.json"))
            trace_bytes = os.path.getsize(trace_path)
            with open(trace_path) as f:
                trace_events = len(json.load(f)["traceEvents"])
        tail_p99 = recorder.explain_tail(0.99, top=64)
        rec_snap = recorder.snapshot(tail=tail_p99)
        on_snap = server_on.telemetry.snapshot(wall_s=wall_on)
        snap = plain["server"].telemetry.snapshot(wall_s=plain["wall_s"])
        dense_launches = [(p["name"], p["log"]["launches"],
                           p["log"]["b1_launches"], p["log"]["b8_launches"])
                          for p in passes]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        ab_logs = {}

        def ab_watch(arm, eng):
            return window_watch(eng, ab_logs.setdefault(arm, {}))

        ab_streams = {}
        multi_ab = serve_multi_step_ab(
            rung, prompts, DENSE_NEW, DENSE_SLOTS, DENSE_CAP, RUNG_STRIDE,
            rtt_s=rtt, chunk_size=DENSE_CHUNK, timeout=600, device=dev,
            watch=ab_watch, streams=ab_streams)
        for arm, log in ab_logs.items():
            window_gates(f"multi-step A/B {arm}", log,
                         RUNG_STRIDE if arm == "on" else 1)
            dense_launches.append((f"multi_step_{arm}", log["launches"],
                                   log["b1_launches"], log["b8_launches"]))
    gc.collect()
    torch.cuda.empty_cache()
    checked, excused, mismatched = greedy_check(rung, dev, prompts,
                                                plain["outs"])
    ab_greedy = arm_greedy(rung, dev, prompts, ab_streams,
                           "serve_rung multi-step A/B")
    wave_exact, wave_multi = one_wave(
        rung, dev, prompts[:DENSE_SLOTS], max_batch=DENSE_SLOTS,
        max_seq_len=DENSE_CAP, chunk_size=DENSE_CHUNK)
    stride_profile = profile_stride(rung, dev, prompts)
    del rung
    gc.collect()
    torch.cuda.empty_cache()
    with counting_plain() as plain_32:
        pair = stride_pair_32(model, dev)
    lat = snap["latency"]
    on, off = multi_ab["on"], multi_ab["off"]
    emit({"phase": "serve_rung", "layers": DENSE_LAYERS, "ff": DENSE_FF,
          "slots": DENSE_SLOTS, "capacity": DENSE_CAP, "chunk": DENSE_CHUNK,
          "horizon": DENSE_HORIZON, "requests": len(prompts),
          "new_tokens": DENSE_NEW, "readout_stride": RUNG_STRIDE,
          "rtt_est_ms": rtt * 1e3,
          "tokens_per_s": {p["name"]: p["tokens_per_s"] for p in passes},
          # what sets a pass's pace: its dispatches, and how many of the
          # 8 slots the first one holds (admission races the submits)
          "dispatches": {p["name"]: len(p["log"]["dispatches"])
                         for p in passes},
          "first_dispatch_resident": {
              p["name"]: p["log"]["resident"][0] for p in passes},
          "prefill_chunks": stats_plain["prefill_chunks"],
          "steps": stats_plain["steps"],
          "flight_recorder_overhead_pct": overhead_pct(off_tps, on_tps),
          "supervision_overhead_pct": overhead_pct(sup_off, sup_on),
          "metrics_store_overhead_pct": overhead_pct(ms_off, ms_on),
          "trace_context_overhead_pct": overhead_pct(tc_off, tc_on),
          "metrics_store_series": store_series,
          "ttft_p50_ms": lat["ttft"]["p50_s"] * 1e3,
          "e2e_p50_ms": lat["e2e"]["p50_s"] * 1e3,
          "stage_share": snap["attribution"]["stage_share"],
          "recorder_on_stage_share": on_snap["attribution"]["stage_share"],
          "tail_causes_p99": rec_snap["tail_causes_p99"],
          "explain_tail_p99": tail_p99[:4],
          "recorder_snapshot": rec_snap, "trace_events": trace_events,
          "trace_bytes": trace_bytes,
          "multi_step": multi_ab,
          "multi_step_speedup": multi_ab["multi_step_speedup"],
          "multi_step_drift": drift(ab_streams["off"], ab_streams["on"]),
          "multi_step_greedy": ab_greedy,
          "one_wave_exact": wave_exact, "one_wave_multi_steps": wave_multi,
          "multi_step_decode_step_ms": {
              arm: median(log["step_ms"]["decode"])
              if log["step_ms"]["decode"] else None
              for arm, log in ab_logs.items()},
          "multi_step_dispatch_rows": {
              arm: collections.Counter(r for k, r in log["dispatches"]
                                       if k == "decode")
              for arm, log in ab_logs.items()},
          "stride_profile": stride_profile,
          "stride_pair_32_layers": pair,
          "greedy_checked": checked, "greedy_excused_near_ties": excused,
          "greedy_mismatched": mismatched, "margin": MARGIN,
          "plain_calls": dict(plain_calls), "plain_calls_32": dict(plain_32),
          "seconds": time.perf_counter() - t_phase})
    for name, launches, b1, b8 in dense_launches:
        require(all(n == 0 for n in launches.values()) and b1 == 0 and b8 == 0,
                f"serve_rung {name}: kernels launched in a dense arm: "
                f"{launches}, B1 {b1}, B8 {b8}")
    require(not plain_calls and not plain_32,
            f"serve_rung: plain versions ran on the card: "
            f"{dict(plain_calls)}, {dict(plain_32)}")
    for p in passes[1:]:
        require(p["tokens"] == plain["tokens"],
                f"serve_rung {p['name']}: streams differ from the plain "
                f"pass: {drift(plain['tokens'], p['tokens'])}")
    require(on["multi_steps"] > 0 and off["multi_steps"] == 0
            and on["host_round_trips"] < off["host_round_trips"],
            f"serve_rung multi-step A/B: {multi_ab}")
    require(wave_exact and wave_multi > 0,
            f"serve_rung one wave: strides 1 and {RUNG_STRIDE} differ "
            f"(exact {wave_exact}, multi-steps {wave_multi})")
    require(mismatched == 0, f"serve_rung: {mismatched} greedy tokens "
            f"disagree with the no-cache forward beyond {MARGIN}")
    return {"b2_decode": pair["b2_launches"],
            "b3_append": pair["b3_launches"]}


# ---------------------------------------------------------------------------
# (d-viii) spec_rung: the llama_serve_spec rung's path (bench.py:587-708)
# ---------------------------------------------------------------------------

#: the rung's speculation: speculative_k and readout_stride (its
#: BENCH_SPEC_K and BENCH_READOUT_STRIDE defaults)
SPEC_K, SPEC_STRIDE = 6, 4
#: the latency arm's batch and requests (min(3, requests) at B 1)
SPEC_B1_REQUESTS = 3
#: the paged pair's block; its capacity is DENSE_PAGED_CAP (a multiple of
#: the chunk), the dense arms' the rung's DENSE_CAP
SPEC_BLOCK = 64


def spec_prompts(vocab):
    """The rung's repetition-heavy prompts, from its seed: per request a
    24-token random base tiled to 256 + U[0, 128) tokens (greedy
    continuations loop, so prompt-lookup drafts accept)."""
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(DENSE_REQUESTS):
        base = rng.integers(0, vocab, (24,)).astype(np.int32)
        want = 256 + int(rng.integers(0, 128))
        prompts.append(np.tile(base, -(-want // len(base)))[:want])
    return prompts


def spec_engine(model, dev, spec_k, batch, **over):
    """The rung's engine: ``LLMEngine(model, max_batch=batch,
    max_seq_len=576, chunk_size=256, scheduler="fused",
    speculative_k=spec_k, readout_stride=4)``, dense unless ``over`` says
    otherwise."""
    return LLMEngine(model, **{**dict(
        max_batch=batch, max_seq_len=DENSE_CAP, chunk_size=DENSE_CHUNK,
        scheduler="fused", speculative_k=spec_k,
        readout_stride=SPEC_STRIDE, device=dev), **over})


def spec_arm(model, dev, prompts, name, spec_k, batch, rtt, margin=MARGIN,
             **over):
    """One serve pass of the rung: a fresh engine (:func:`spec_engine`)
    warmed by one 2-token request, its stats reset, then ``prompts``
    through AsyncLLMServer with a flight recorder, the whole serve under
    :func:`window_watch`. Gates: every request finishes with its 64
    tokens, the server healthy, the sync and record gates
    (:func:`window_gates`), multi-step dispatches under the fused
    scheduler, proposals and accepted drafts in a speculative arm, the
    greedy check under ``margin``. Returns the arm's line, its log and its
    tokens."""
    eng = spec_engine(model, dev, spec_k, batch, **over)
    eng.generate([prompts[0]], max_new_tokens=2)
    torch.cuda.synchronize()
    eng.reset_stats()
    rec, log = FlightRecorder(), {}
    srv = AsyncLLMServer(eng, max_queue_size=len(prompts) + 1,
                         flight_recorder=rec)
    with window_watch(eng, log):
        srv.start()
        t0 = time.perf_counter()
        hs = [srv.submit(p, max_new_tokens=DENSE_NEW) for p in prompts]
        outs = [h.result(timeout=600) for h in hs]
        wall = time.perf_counter() - t0
        health = srv.health()
        srv.stop()
    st = dict(eng.stats)
    snap = srv.telemetry.snapshot(wall_s=wall)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    require(all(o.finished and o.finish_reason == "length"
                and len(o.token_ids) == DENSE_NEW for o in outs),
            f"{name}: a request did not finish with its {DENSE_NEW} tokens")
    require(health["healthy"], f"{name}: server {health['state']} at the end")
    window_gates(name, log, SPEC_STRIDE, spec_k)
    n_tok = sum(len(o.token_ids) for o in outs)
    prop, acc = st["spec_proposed_tokens"], st["spec_accepted_tokens"]
    spec_rows = [r for k, r in log["dispatches"] if k == "spec"]
    checked, excused, mismatched = greedy_check(model, dev, prompts, outs,
                                                margin)
    lat = snap["latency"]
    decode_ms = log["step_ms"]["spec"] + log["step_ms"]["decode"]
    fused = over.get("scheduler", "fused") == "fused"
    arm = {"arm": name, "speculative_k": spec_k, "batch": batch,
           "requests": len(prompts), "cache_impl": over.get(
               "cache_impl", "dense"),
           "scheduler": "fused" if fused else "legacy",
           "tokens_per_s": n_tok / wall, "wall_s": wall,
           "steps": st["steps"], "mixed_steps": sum(
               k == "mixed" for k, _ in log["dispatches"]),
           "multi_steps": st["multi_steps"],
           "spec_proposed_tokens": prop, "spec_accepted_tokens": acc,
           "acceptance_rate": acc / prop if prop else None,
           "accepted_per_step": st["draft_tokens_accepted"]
           / max(st["steps"], 1),
           "windows_per_dispatch": float(np.mean(spec_rows))
           if spec_rows else None,
           "rtt_share": rtt * st["steps"] / wall,
           "ttft_p50_ms": lat["ttft"]["p50_s"] * 1e3,
           "e2e_p50_ms": lat["e2e"]["p50_s"] * 1e3,
           "decode_step_ms_median": median(decode_ms) if decode_ms
           else None,
           "mixed_step_ms_median": median(log["step_ms"]["mixed"])
           if log["step_ms"]["mixed"] else None,
           "launches": log["launches"], "b1_launches": log["b1_launches"],
           "b8_launches": log["b8_launches"],
           "step_begin_syncs": log["begin"],
           "greedy_margin": margin,
           "greedy_checked": checked, "greedy_excused_near_ties": excused,
           "greedy_mismatched": mismatched}
    require(not fused or st["multi_steps"] > 0,
            f"{name}: no multi-step dispatch")
    require(spec_k == 1 or (prop > 0 and spec_rows
                            and st["draft_tokens_accepted"] > 0),
            f"{name}: no verify window proposed or no draft accepted "
            f"({prop}, {st['draft_tokens_accepted']}, {spec_rows})")
    require(spec_k > 1 or not spec_rows, f"{name}: spec dispatches")
    require(mismatched == 0, f"{name}: {mismatched} greedy tokens disagree "
            f"with the no-cache forward beyond {margin}")
    return arm, log, [list(o.token_ids) for o in outs]


def first_parting(model, dev, prompts, want, got):
    """Where two arms' streams part: per request that differs, the first
    step and the no-cache forward's top-1/top-2 margin there (over the
    prompt and the common prefix). A margin at most MARGIN is a near-tie:
    bf16 products over a verify window's rows and over one row round
    apart, and the argmax may then go either way."""
    parts = []
    with torch.no_grad():
        for i, (p, a, b) in enumerate(zip(prompts, want, got)):
            if a == b:
                continue
            n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            seq = np.concatenate([p, np.asarray(a[:n], np.int32)])
            row = model(torch.from_numpy(seq[None]).to(dev))[0, -1].float()
            top2 = torch.topk(row, 2).values
            parts.append({"request": i, "step": n, "margin":
                          float(top2[0] - top2[1])})
    return parts


def spec_one_wave(model, dev, prompts, **over):
    """One wave (8 requests, 8 slots, no re-admission) straight from
    ``generate`` through engines with speculation on and off: their
    streams must be equal, or part only at a near-tie, which is
    reported."""
    toks = {}
    for k in (SPEC_K, 1):
        eng = spec_engine(model, dev, k, DENSE_SLOTS, **over)
        toks[k] = [list(o.token_ids) for o in eng.generate(
            prompts, max_new_tokens=DENSE_NEW)]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    parts = first_parting(model, dev, prompts, toks[1], toks[SPEC_K])
    return {"token_exact": not parts, "partings": parts,
            "near_ties_only": all(p["margin"] <= MARGIN for p in parts)}


def profile_spec(rung, dev, prompts, n_steps=2):
    """Where a speculative all-decode dispatch's time goes, against the
    control's: the rung's first eight requests in fresh dense engines at
    speculative_k 6 and 1 (readout_stride 4), ramped in and one dispatch
    warmed, then ``n_steps`` all-decode dispatches traced at depth 1:
    device busy and idle share, device events a dispatch and a row (a
    verify window, or a decode iteration)."""
    out = {}
    for arm, k in (("on", SPEC_K), ("off", 1)):
        eng = spec_engine(rung, dev, k, DENSE_SLOTS)
        for p in prompts[:DENSE_SLOTS]:
            eng.add_request(p, max_new_tokens=DENSE_NEW)
        eng.step()                  # admission assigns the slots
        while any(s is not None and s.ramping for s in eng.slots):
            eng.step()
        eng.step()                  # one all-decode dispatch, warm
        torch.cuda.synchronize()
        rows, kinds = [], []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                pending = eng.step_begin()
                require(pending is not None and pending.toks is not None,
                        "spec profile: a step dispatched nothing")
                rows.append(int(pending.toks.shape[0]))
                kinds.append(pending.kind)
                eng.step_finish(pending)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        require(set(kinds) == {"spec" if k > 1 else "decode"},
                f"spec profile {arm}: dispatched {kinds}")
        win = device_breakdown(prof, wall, n_steps)
        if win is not None:
            win.update(rows_per_dispatch=rows, events_per_row=win[
                "events_per_step"] * n_steps / sum(rows))
        out[arm] = win
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def spec_rung_model(dev):
    """The llama_serve_spec rung's model (and llama_serve's): 7B widths,
    ff 11264, 3 layers, MHA, bf16, seed 0, a rope table for the paged
    arms' capacity."""
    return build_model(dev, num_hidden_layers=DENSE_LAYERS,
                       intermediate_size=DENSE_FF,
                       max_position_embeddings=DENSE_PAGED_CAP)


def spec_rtt(rung, dev, prompts, **over):
    """One host round trip (a one-float read of the carried logits) of a
    warmed speculative engine at B 8 (:func:`spec_engine` with ``over``),
    the median of five: what ``rtt_share`` multiplies by the steps."""
    warm = spec_engine(rung, dev, SPEC_K, DENSE_SLOTS, **over)
    warm.generate([prompts[0]], max_new_tokens=2)
    torch.cuda.synchronize()
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        float(warm._logits[0, 0])
        rtts.append(time.perf_counter() - t0)
    del warm
    return median(rtts)


def run_spec_rung(rung, dev):
    """(d-viii): the llama_serve_spec rung. Its model ``rung``
    (:func:`spec_rung_model`) and its 16 repetition-heavy
    requests (256-383 tokens, 64 new) through AsyncLLMServer over dense
    fused engines at ``speculative_k=6, readout_stride=4`` against
    ``speculative_k=1``, at B 8 and at B 1 (3 requests), then the B 8 pair
    over paged bf16 engines (block 64, capacity 768). Gates: every request
    finishes with its 64 tokens; the greedy check on every arm; one wave
    of 8 requests spec-on against spec-off token-exact, dense and paged
    (a parting only at a near-tie, reported); proposals in the spec arms;
    multi-step dispatches in every arm; StepRecords of kind "spec" at
    ``readout_stride`` 6 x 4 with at most 4 windows, mixed steps at 6 (1
    off) and the sync gates of :func:`window_gates`; no kernel and no
    counted plain version in a dense arm; in the paged spec arm B3 once a
    layer for every verify window the host dispatches (each all-decode
    dispatch's windows: ``min(4, largest remaining budget)``) and every
    mixed step, and never B2; in the paged control arm B2 once a layer a
    decode iteration and B3 a mixed step. Then two all-decode dispatches
    of each dense engine traced (:func:`profile_spec`; information).
    Returns the paged pair's B2 and B3 launches and the dense B 8 spec
    arm's tokens/s."""
    t_phase = time.perf_counter()
    L = rung.config.num_hidden_layers
    prompts = spec_prompts(rung.config.vocab_size)
    rtt = spec_rtt(rung, dev, prompts)
    paged = dict(cache_impl="paged", block_size=SPEC_BLOCK,
                 max_seq_len=DENSE_PAGED_CAP)
    arms, logs, toks = {}, {}, {}
    with counting_plain() as plain_calls:
        for name, k, batch, reqs, over in (
                ("b8_on", SPEC_K, DENSE_SLOTS, prompts, {}),
                ("b8_off", 1, DENSE_SLOTS, prompts, {}),
                ("b1_on", SPEC_K, 1, prompts[:SPEC_B1_REQUESTS], {}),
                ("b1_off", 1, 1, prompts[:SPEC_B1_REQUESTS], {}),
                ("paged_b8_on", SPEC_K, DENSE_SLOTS, prompts, paged),
                ("paged_b8_off", 1, DENSE_SLOTS, prompts, paged)):
            arms[name], logs[name], toks[name] = spec_arm(
                rung, dev, reqs, name, k, batch, rtt, **over)
        wave = {"dense": spec_one_wave(rung, dev, prompts[:DENSE_SLOTS]),
                "paged": spec_one_wave(rung, dev, prompts[:DENSE_SLOTS],
                                       **paged)}
    spec_profile = profile_spec(rung, dev, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    for name, arm in arms.items():
        got = arm["launches"]
        if arm["cache_impl"] == "dense":
            require(all(n == 0 for n in got.values())
                    and arm["b1_launches"] == 0 and arm["b8_launches"] == 0,
                    f"spec_rung {name}: kernels launched in a dense arm: "
                    f"{got}, B1 {arm['b1_launches']}, B8 "
                    f"{arm['b8_launches']}")
            continue
        disp = logs[name]["dispatches"]
        windows = sum(r for k, r in disp if k == "spec")
        iters = sum(r for k, r in disp if k == "decode")
        n_mixed = sum(k == "mixed" for k, _ in disp)
        # B3: one launch a layer per model call over a paged window, i.e.
        # each mixed step and each verify window the host dispatched; B2:
        # one a layer per plain decode iteration (the control arm only)
        want = {"b3_append": (windows + n_mixed) * L, "b2_decode": iters * L}
        arm.update(verify_windows=windows, decode_iterations=iters,
                   expected_launches=want)
        require(got["b3_append"] == want["b3_append"]
                and got["b2_decode"] == want["b2_decode"]
                and got["b3_append"] > 0
                and all(n == 0 for q, n in got.items() if q.startswith("b4"))
                and arm["b8_launches"] == 0,
                f"spec_rung {name}: launches {got}, expected {want} for "
                f"{windows} verify windows, {iters} decode iterations and "
                f"{n_mixed} mixed steps a layer")
    require(not plain_calls, f"spec_rung: plain versions ran on the card: "
            f"{dict(plain_calls)}")
    for form, w in wave.items():
        require(w["near_ties_only"],
                f"spec_rung one wave ({form}): spec on and off part beyond "
                f"a near-tie: {w['partings']}")

    def speedup(on, off):
        return arms[on]["tokens_per_s"] / arms[off]["tokens_per_s"]

    emit({"phase": "spec_rung", "layers": DENSE_LAYERS, "ff": DENSE_FF,
          "slots": DENSE_SLOTS, "capacity": DENSE_CAP,
          "paged_capacity": DENSE_PAGED_CAP, "chunk": DENSE_CHUNK,
          "speculative_k": SPEC_K, "readout_stride": SPEC_STRIDE,
          "requests": len(prompts), "b1_requests": SPEC_B1_REQUESTS,
          "new_tokens": DENSE_NEW,
          "prompt_lens": [len(p) for p in prompts],
          "rtt_est_ms": rtt * 1e3,
          "speculation_speedup": speedup("b8_on", "b8_off"),
          "speculation_speedup_b1": speedup("b1_on", "b1_off"),
          "speculation_speedup_paged": speedup("paged_b8_on",
                                               "paged_b8_off"),
          "token_parity": {"b8": toks["b8_on"] == toks["b8_off"],
                           "b1": toks["b1_on"] == toks["b1_off"],
                           "paged_b8": toks["paged_b8_on"]
                           == toks["paged_b8_off"]},
          "drift_b8": drift(toks["b8_off"], toks["b8_on"]),
          "drift_paged_b8": drift(toks["paged_b8_off"], toks["paged_b8_on"]),
          "one_wave": wave, "arms": arms, "profile": spec_profile,
          "margin": MARGIN,
          "plain_calls": dict(plain_calls),
          "seconds": time.perf_counter() - t_phase})
    return {"b2_decode": arms["paged_b8_off"]["launches"]["b2_decode"],
            "b3_append": arms["paged_b8_on"]["launches"]["b3_append"]
            + arms["paged_b8_off"]["launches"]["b3_append"],
            "b8_on_tokens_per_s": arms["b8_on"]["tokens_per_s"]}


# ---------------------------------------------------------------------------
# (d-ix) legacy_spec: the legacy scheduler's speculative scan
# ---------------------------------------------------------------------------

#: the reference's default speculation, LLMEngine(model, max_batch=8,
#: max_seq_len=576, chunk_size=256, horizon=4, speculative_k=6): the
#: legacy dense scan, as spec_engine's arguments
LEGACY_SPEC = dict(scheduler="legacy", readout_stride=1, horizon=SPEC_STRIDE)


@contextlib.contextmanager
def b8_rows():
    """The row count of every x the weight-only layers hand B8 (through
    ``nn.quant``'s kernel route) for the duration, as a Counter."""
    rows = collections.Counter()
    route = quant_mod.int4_matmul

    def logged(x2d, *a, **k):
        rows[int(x2d.shape[0])] += 1
        return route(x2d, *a, **k)

    quant_mod.int4_matmul = logged
    try:
        yield rows
    finally:
        quant_mod.int4_matmul = route


def run_legacy_spec(rung, dev, fused_b8_on_tps):
    """(d-ix): the legacy scheduler's speculative scan, the reference's
    default speculation, on (d-viii)'s model ``rung`` and prompts, through
    AsyncLLMServer with a flight recorder: legacy dense engines at
    ``speculative_k=6, horizon=4`` against ``speculative_k=1`` at B 8 and
    at B 1 (3 requests), then one spec arm at B 8 over ``rung`` quantized
    in place to weight-only int4 (``use_pallas_int4`` on), as (d-iii)
    quantizes, with the greedy margin widened by the measured logit gap
    between B8 and the split-nibble route. Gates (:func:`spec_arm`): every
    request finishes with its 64 tokens, the greedy check, proposals and
    accepted drafts, StepRecords of kind "spec" at ``readout_stride`` 6 x 4
    with at most 4 windows (decode at 4 in the control arms), the sync
    gates of :func:`window_gates`; one wave of 8 requests spec-on against
    spec-off token-exact up to a near-tie (reported); no kernel and no
    counted plain version in a bf16 arm; in the int4 arm B8 once for each
    of the 7 projections a layer of every verify window the host
    dispatches, every B8 call at 8 x 6 = 48 rows, and never
    ``int4_matmul_plain``. Information: per arm tokens/s, acceptance,
    accepted drafts per step, windows per dispatch, TTFT and e2e p50;
    ``speculation_speedup`` at B 8 and B 1, and the B 8 spec arm against
    (d-viii)'s fused one (``fused_b8_on_tps``). Returns the int4 arm's
    B8 launches. Leaves ``rung`` quantized."""
    t_phase = time.perf_counter()
    L = rung.config.num_hidden_layers
    prompts = spec_prompts(rung.config.vocab_size)
    rtt = spec_rtt(rung, dev, prompts, **LEGACY_SPEC)
    arms, logs, toks = {}, {}, {}
    with counting_plain() as plain_calls:
        for name, k, batch, reqs in (
                ("b8_on", SPEC_K, DENSE_SLOTS, prompts),
                ("b8_off", 1, DENSE_SLOTS, prompts),
                ("b1_on", SPEC_K, 1, prompts[:SPEC_B1_REQUESTS]),
                ("b1_off", 1, 1, prompts[:SPEC_B1_REQUESTS])):
            arms[name], logs[name], toks[name] = spec_arm(
                rung, dev, reqs, name, k, batch, rtt, **LEGACY_SPEC)
        wave = spec_one_wave(rung, dev, prompts[:DENSE_SLOTS],
                             **LEGACY_SPEC)
        bf16_plain = dict(plain_calls)
        t0 = time.perf_counter()
        _, n_swaps = quantize_linears_for_inference(rung, weight_dtype="int4")
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        require(n_swaps == 7 * L + 1, f"legacy_spec int4: {n_swaps} swaps, "
                f"expected {7 * L + 1}")
        gap, n_on = route_gap(rung, dev, prompts)
        require(n_on == 7 * L, f"legacy_spec route gap: {n_on} B8 launches "
                f"in the kernel-route forward, expected {7 * L}")
        with b8_rows() as rows:
            arms["int4_b8_on"], logs["int4_b8_on"], toks["int4_b8_on"] = \
                spec_arm(rung, dev, prompts, "int4_b8_on", SPEC_K,
                         DENSE_SLOTS, rtt, margin=MARGIN + 4 * gap,
                         **LEGACY_SPEC)
    gc.collect()
    torch.cuda.empty_cache()
    for name, arm in arms.items():
        got = arm["launches"]
        require(all(n == 0 for n in got.values())
                and arm["b1_launches"] == 0,
                f"legacy_spec {name}: attention kernels launched: {got}, "
                f"B1 {arm['b1_launches']}")
        if name != "int4_b8_on":
            require(arm["b8_launches"] == 0, f"legacy_spec {name}: B8 "
                    f"launched {arm['b8_launches']} times")
            continue
        windows = sum(r for kd, r in logs[name]["dispatches"] if kd == "spec")
        want = 7 * L * windows
        arm.update(verify_windows=windows, expected_b8_launches=want,
                   b8_rows=dict(rows), quantize_s=quant_s,
                   route_logit_gap=gap)
        require(arm["b8_launches"] == want and want > 0,
                f"legacy_spec {name}: {arm['b8_launches']} B8 launches, "
                f"expected {want} (7 a layer of {L} for {windows} verify "
                f"windows)")
        require(set(rows) == {DENSE_SLOTS * SPEC_K},
                f"legacy_spec {name}: B8 took rows {dict(rows)}, expected "
                f"only {DENSE_SLOTS * SPEC_K}")
    require(not plain_calls, f"legacy_spec: plain versions ran on the "
            f"card: {dict(plain_calls)}")
    require(wave["near_ties_only"],
            f"legacy_spec one wave: spec on and off part beyond a "
            f"near-tie: {wave['partings']}")

    def speedup(on, off):
        return arms[on]["tokens_per_s"] / arms[off]["tokens_per_s"]

    emit({"phase": "legacy_spec", "layers": L, "ff": DENSE_FF,
          "slots": DENSE_SLOTS, "capacity": DENSE_CAP, "chunk": DENSE_CHUNK,
          "speculative_k": SPEC_K, "horizon": SPEC_STRIDE,
          "requests": len(prompts), "b1_requests": SPEC_B1_REQUESTS,
          "new_tokens": DENSE_NEW, "rtt_est_ms": rtt * 1e3,
          "speculation_speedup": speedup("b8_on", "b8_off"),
          "speculation_speedup_b1": speedup("b1_on", "b1_off"),
          "legacy_over_fused_spec_b8": arms["b8_on"]["tokens_per_s"]
          / fused_b8_on_tps,
          "fused_b8_on_tokens_per_s": fused_b8_on_tps,
          "token_parity": {"b8": toks["b8_on"] == toks["b8_off"],
                           "b1": toks["b1_on"] == toks["b1_off"]},
          "drift_b8": drift(toks["b8_off"], toks["b8_on"]),
          "drift_int4_b8": drift(toks["b8_on"], toks["int4_b8_on"]),
          "one_wave": wave, "arms": arms, "margin": MARGIN,
          "plain_calls": bf16_plain,
          "seconds": time.perf_counter() - t_phase})
    return arms["int4_b8_on"]["b8_launches"]


# ---------------------------------------------------------------------------
# (d-x) the host KV tier: the llama_serve_kv_tier rung
# ---------------------------------------------------------------------------

#: the rung's traffic and engine (bench.py:1362-1451, its defaults): the
#: 3-layer model at 7B widths (ff 11264, MHA, bf16, seed 0) with a rope
#: table of the capacity; 16 requests of 249-263 tokens, one of two shared
#: 153-token system prompts in alternation before a unique tail, 64 new
#: tokens each; 8 slots, chunk 256, block 64, capacity 512, the prefix
#: cache on; the pressured pool holds half the 64-block demand, the spill
#: store 256 MiB
KT_REQUESTS, KT_PROMPT, KT_SYS_FRAC, KT_NEW = 16, 256, 0.6, 64
KT_CAP = -(-(KT_PROMPT + KT_NEW) // DENSE_CHUNK) * DENSE_CHUNK
KT_FULL = DENSE_SLOTS * (KT_CAP // 64)
KT_POOL = KT_FULL // 2
KT_SPILL = 256 << 20
KT_TIER = dict(kv_host_swap=True, kv_host_spill_bytes=KT_SPILL)
#: (arm, KV dtype, pool blocks, tier on)
KT_ARMS = (("floor", None, KT_FULL, False), ("off", None, KT_POOL, False),
           ("on", None, KT_POOL, True),
           ("int8_floor", "int8", KT_FULL, False),
           ("int8_on", "int8", KT_POOL, True))
TIER_STATS = ("preemptions", "prefill_tokens", "prefix_hit_tokens",
              "kv_swap_out_blocks", "kv_swap_in_blocks", "kv_swap_out_bytes",
              "kv_swap_in_bytes", "kv_swap_saved_tokens", "kv_spill_blocks",
              "kv_promote_blocks", "swap_out_time_s", "swap_in_time_s")


def kv_tier_model(dev):
    return build_model(dev, num_hidden_layers=DENSE_LAYERS,
                       intermediate_size=DENSE_FF,
                       max_position_embeddings=KT_CAP)


def kv_tier_prompts(vocab):
    """The rung's prompts (bench.py:1386-1393)."""
    rng = np.random.default_rng(0)
    sys_len = int(KT_PROMPT * KT_SYS_FRAC)
    heads = [rng.integers(0, vocab, (sys_len,)).astype(np.int32)
             for _ in range(2)]
    return [np.concatenate([heads[i % 2], rng.integers(
        0, vocab, (KT_PROMPT - sys_len - 7 + int(x),)).astype(np.int32)])
        for i, x in enumerate(rng.integers(0, 15, size=KT_REQUESTS))]


def tier_report(eng, wall_s):
    """The host KV tier's line of an arm: its counters, the swap stall
    share of the serve wall (host seconds in the tier's calls: the copies
    themselves are asynchronous), bytes over those seconds, the spill
    store at the end, and the end state the gates read."""
    st = {k: eng.stats[k] for k in TIER_STATS}
    stall = st["swap_out_time_s"] + st["swap_in_time_s"]
    return {**st, "swap_stall_share": stall / wall_s,
            "swap_out_bytes_per_host_s": st["kv_swap_out_bytes"]
            / st["swap_out_time_s"] if st["swap_out_time_s"] else None,
            "swap_in_bytes_per_host_s": st["kv_swap_in_bytes"]
            / st["swap_in_time_s"] if st["swap_in_time_s"] else None,
            "spill_entries": len(eng._spill),
            "spill_bytes": eng._spill_bytes,
            "swap_store_empty": not eng._swap_store,
            "blocks_free_or_cached":
                len(eng._free_blocks) + len(eng._lru) == eng.n_blocks}


def tier_copy_rate(model, dev, n=8, reps=5):
    """The tier's copies on the card, timed with CUDA events: a swap-out of
    ``n`` blocks (the gather of every layer's K and V blocks and its copy
    into pinned host memory) and a restore of them (the copy up and the
    scatter into ``n`` other blocks), median of ``reps`` after a warm
    pair; the host ms of the swap-out call, the first (which may have to
    page-lock a new pinned buffer) and the median of the rest; then the
    restored blocks against their sources, bit for bit."""
    eng = make_fused_engine(model, dev, kv_pool_blocks=2 * n,
                            max_seq_len=KT_CAP, kv_host_swap=True)
    pools, _ = eng._tier_pools()
    gen = torch.Generator(device=dev).manual_seed(3)
    for p in pools:
        p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                            dtype=torch.float32).to(p.dtype))
    src, dst = list(range(n)), list(range(n, 2 * n))
    out_ms, in_ms, host_ms = [], [], []
    for i in range(reps + 1):
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        t0 = time.perf_counter()
        entry = eng._stage_blocks(src)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b.record()
        eng._restore_blocks(entry, 0, dst)
        c.record()
        torch.cuda.synchronize()
        if i:
            out_ms.append(a.elapsed_time(b))
            in_ms.append(b.elapsed_time(c))
    exact = all(torch.equal(p[src], p[dst]) for p in pools)
    nbytes = n * eng.kv_bytes_per_block()
    pinned = entry["kv"].is_pinned()
    del eng, entry
    torch.cuda.empty_cache()
    return {"blocks": n, "bytes": nbytes, "pinned": pinned,
            "swap_out_ms": median(out_ms), "swap_in_ms": median(in_ms),
            "swap_out_gb_per_s": nbytes / median(out_ms) / 1e6,
            "swap_in_gb_per_s": nbytes / median(in_ms) / 1e6,
            "swap_out_host_ms_first": host_ms[0],
            "swap_out_host_ms_later": median(host_ms[1:]),
            "restored_bits_equal": exact}


def run_kv_tier(dev):
    """The llama_serve_kv_tier rung's traffic through AsyncLLMServer over
    the rung's engine in five arms (KT_ARMS): the floor, the pressured
    pool with the tier off and on, and an int8 pool's floor and tier-on
    pair; the tier's copies timed alone. Returns the paged launches of
    the arms, summed."""
    t_phase = time.perf_counter()
    model = kv_tier_model(dev)
    vocab = model.config.vocab_size
    prompts = kv_tier_prompts(vocab)
    warm = np.random.default_rng(1).integers(0, vocab, (3,)).astype(np.int32)
    arms, toks = {}, {}
    for name, quant, n_blocks, on in KT_ARMS:
        arms[name], toks[name] = serve_arm(
            model, dev, prompts, quant, n_blocks, name=f"kv_tier {name}",
            n_new=KT_NEW, warm=warm, tier=True, burst=True,
            max_seq_len=KT_CAP,
            enable_prefix_cache=True, **(KT_TIER if on else {}))
        gc.collect()
        torch.cuda.empty_cache()
    greedy = {}
    for name in ("floor", "off", "on"):
        greedy[name] = greedy_check(model, dev, prompts, [
            collections.namedtuple("Out", "token_ids")(t)
            for t in toks[name]])
    parts = {"on": first_parting(model, dev, prompts, toks["floor"],
                                 toks["on"]),
             "int8_on": first_parting(model, dev, prompts,
                                      toks["int8_floor"], toks["int8_on"])}
    copies = tier_copy_rate(model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # prefill tokens beyond the floor arm's, reported as information: it
    # can be negative, since the floor's 8 concurrent ramps miss each
    # other's shared heads where a pressured pool's staggered admissions
    # hit them. The gate compares the pressured arms' prefill directly
    pre = {k: a["tier"]["prefill_tokens"] for k, a in arms.items()}
    beyond = {"off": pre["off"] - pre["floor"],
              "on": pre["on"] - pre["floor"],
              "int8_on": pre["int8_on"] - pre["int8_floor"]}
    emit({"phase": "kv_tier", "requests": KT_REQUESTS,
          "prompt_lens": [len(p) for p in prompts], "new_tokens": KT_NEW,
          "capacity": KT_CAP, "full_blocks": KT_FULL, "pool_blocks": KT_POOL,
          "spill_bytes": KT_SPILL, "prefill_tokens": pre,
          "prefill_beyond_floor": beyond,
          "tokens_per_s": {k: a["tokens_per_s"] for k, a in arms.items()},
          "ttft_p50_s": {k: a["ttft_p50_s"] for k, a in arms.items()},
          "tiering_speedup": arms["on"]["tokens_per_s"]
          / arms["off"]["tokens_per_s"],
          "partings": parts, "copies": copies,
          "greedy": {k: {"checked": c, "excused_near_ties": e,
                         "mismatched": m}
                     for k, (c, e, m) in greedy.items()},
          "arms": arms, "margin": MARGIN,
          "seconds": time.perf_counter() - t_phase})
    require(arms["off"]["preemptions"] >= 1,
            "kv_tier off arm: no preemption, the pool is not pressured")
    require(pre["on"] < pre["off"],
            f"kv_tier: the on arm prefilled {pre['on']} tokens, not fewer "
            f"than the off arm's {pre['off']}")
    for name in ("on", "int8_on"):
        t = arms[name]["tier"]
        require(t["kv_swap_out_blocks"] >= 1 and t["kv_swap_in_blocks"] >= 1
                and t["kv_swap_saved_tokens"] >= 1,
                f"kv_tier {name} arm: no swap cycle: {t}")
    for name, a in arms.items():
        require(a["pool_invariants"] and a["tier"]["swap_store_empty"]
                and a["tier"]["blocks_free_or_cached"],
                f"kv_tier {name} arm: the pool or the swap store did not "
                f"drain: {a['tier']}")
    for name, ps in parts.items():
        require(all(p["margin"] <= MARGIN for p in ps),
                f"kv_tier {name} arm parts from its floor where the margin "
                f"exceeds {MARGIN}: {ps}")
    for name, (_, _, mismatched) in greedy.items():
        require(mismatched == 0, f"kv_tier {name} arm: {mismatched} greedy "
                f"tokens disagree with the no-cache forward beyond {MARGIN}")
    require(copies["restored_bits_equal"] and copies["pinned"],
            "kv_tier: a restored block differs from its source, or the "
            "host copy is not in pinned memory")
    total = collections.Counter()
    for a in arms.values():
        total.update(a["launches"])
    return dict(total)


# ---------------------------------------------------------------------------
# (d-xi) the replica router: the llama_serve_cluster rung
# ---------------------------------------------------------------------------

#: the rung's traffic and engines (bench.py:1870-2020, its defaults): the
#: 3-layer model at 7B widths (ff 11264, MHA, bf16, seed 0) with a rope
#: table of the capacity, one copy per replica; 2 tenants, each prompt a
#: tenant's 256-token system prompt before a 64-127-token tail, 32
#: prompts, 64 new tokens each; 8 slots, chunk 256, horizon 64, block 64,
#: paged, fused, the prefix cache on
CL_REPLICAS, CL_TENANTS, CL_SYS, CL_TAIL, CL_NEW = 2, 2, 256, 128, 64
CL_REQUESTS = 2 * DENSE_SLOTS * CL_REPLICAS
CL_CAP = -(-(CL_SYS + CL_TAIL + CL_NEW) // DENSE_CHUNK) * DENSE_CHUNK
#: the failover arm's watchdog on replica 0 (well above a warm step of
#: either replica on the shared card) and its wedge, longer than the
#: failover takes
CL_STEP_TIMEOUT_S, CL_HANG_S = 3.0, 10.0
#: (arm, replicas, policy, failover); single_2 repeats single in the same
#: call, for the run-to-run spread of its rate and of its streams
CL_ARMS = (("single", 1, "affinity", False),
           ("single_2", 1, "affinity", False),
           ("cluster", CL_REPLICAS, "affinity", False),
           ("random", CL_REPLICAS, "random", False),
           ("failover", CL_REPLICAS, "affinity", True))


def cluster_traffic(vocab):
    """The rung's prompts and each replica's 3-token warm prompt, drawn
    from one generator in the rung's order (bench.py:1899-1930)."""
    rng = np.random.default_rng(0)
    heads = [rng.integers(0, vocab, (CL_SYS,)).astype(np.int32)
             for _ in range(CL_TENANTS)]
    tails = [rng.integers(0, vocab, (CL_TAIL // 2 + int(x),)).astype(
        np.int32) for x in rng.integers(0, CL_TAIL // 2, size=CL_REQUESTS)]
    prompts = [np.concatenate([heads[i % CL_TENANTS], t])
               for i, t in enumerate(tails)]
    warms = [rng.integers(0, vocab, (3,)).astype(np.int32)
             for _ in range(CL_REPLICAS)]
    return prompts, warms


def cluster_replica(model, dev, i, warm, log, syncs=None,
                    fault_injector=None, before_begin=None):
    """One replica as the rung makes it: the engine warmed with one
    2-token request (then reset and its stats zeroed), behind its own
    AsyncLLMServer. Each dispatch's kind and rows land in ``log``, on the
    replica's own thread; with ``syncs`` every step_begin runs under
    CUDA's sync debug mode (process-wide, so only with one replica);
    ``before_begin`` is called on that thread ahead of each step_begin."""
    eng = LLMEngine(model, max_batch=DENSE_SLOTS, max_seq_len=CL_CAP,
                    chunk_size=DENSE_CHUNK, horizon=DENSE_HORIZON,
                    cache_impl="paged", block_size=64, scheduler="fused",
                    enable_prefix_cache=True, device=dev)
    eng.generate([warm], max_new_tokens=2)
    torch.cuda.synchronize()
    eng.reset()
    eng.reset_stats()
    begin = eng.step_begin

    def logged_begin():
        if before_begin is not None:
            before_begin()
        if syncs is None:
            pending = begin()
        else:
            with sync_watch(syncs):
                pending = begin()
        if pending is not None and pending.toks is not None:
            log.append((pending.kind, int(pending.toks.shape[0])))
        return pending

    eng.step_begin = logged_begin
    return AsyncLLMServer(
        eng, max_queue_size=CL_REQUESTS + 1, replica=i,
        fault_injector=fault_injector,
        step_timeout_s=CL_STEP_TIMEOUT_S if fault_injector else None)


def cluster_arm(models, dev, prompts, warms, name, n, policy, failover):
    """One arm of the rung: ``n`` replicas behind a ReplicaRouter, the
    seed wave (one request per tenant, waited for), then the timed wave
    (the other 30 at once, ``routing_key`` their tenant). ``failover``:
    ``resume_inflight``, a FaultInjector on replica 0, and a
    non-interruptible wedge of CL_HANG_S at the first step of replica 0
    that finds a timed request there mid-stream; the caller consumes that
    request's first token. Gates: every request finishes with its 64
    tokens, the router stops with nothing outstanding, no plain version
    runs, each replica's B3 launches equal its mixed steps and its B2
    launches its decode iterations (once a layer each, summed over the
    replicas against the counters), and with one replica no step_begin
    synchronizes; with ``failover``, the resumed requests number the
    router's ``resumed`` and each stream starts with the tokens its caller
    had consumed. Returns the arm's line and its streams, seed wave
    first."""
    logs = [[] for _ in range(n)]
    syncs = [] if n == 1 else None
    fi = FaultInjector() if failover else None
    fail, wedge, timed = {}, {}, threading.Event()
    replicas = []

    def wedge_mid_stream():
        # on replica 0's thread, ahead of its step_begin: the first time a
        # timed request there has streamed and not finished (a horizon-64
        # readout can carry a whole stream), wedge this very step
        if not timed.is_set() or wedge:
            return
        srv = replicas[0]
        with srv._hlock:
            mid = [h.request_id for h in srv._handles.values()
                   if h.emitted and not h.done]
        if mid:
            wedge.update(rid=mid[0], mid_stream=len(mid),
                         t=time.perf_counter())
            fi.hang_at_step(1, seconds=CL_HANG_S, interruptible=False)

    for i in range(n):
        replicas.append(cluster_replica(
            models[i], dev, i, warms[i], logs[i], syncs,
            fi if i == 0 else None,
            wedge_mid_stream if failover and i == 0 else None))
    router = ReplicaRouter(replicas, policy=policy,
                           resume_inflight=failover)
    reset_kernel_counts()
    with counting_plain() as plain_calls:
        router.start()
        t_seed = time.perf_counter()
        seed_hs = [router.submit(prompts[i], max_new_tokens=CL_NEW,
                                 routing_key=f"tenant{i % CL_TENANTS}")
                   for i in range(CL_TENANTS)]
        outs = [h.result(timeout=600) for h in seed_hs]
        seed_s = time.perf_counter() - t_seed
        for srv in replicas:
            srv.engine.reset_stats()
        t0 = time.perf_counter()
        timed.set()
        hs = [router.submit(p, max_new_tokens=CL_NEW,
                            routing_key=f"tenant{i % CL_TENANTS}")
              for i, p in enumerate(prompts[CL_TENANTS:], start=CL_TENANTS)]
        if failover:
            while not wedge:
                require(time.perf_counter() - t0 < 600,
                        f"cluster {name}: no timed request on replica 0 "
                        f"was ever mid-stream at a step")
                time.sleep(0.001)
            # the caller consumes a wedged request's first token, so its
            # resumption continues from a nonempty prefix
            victim = next(h for h in hs if h.replica == 0
                          and h._inner.request_id == wedge["rid"])
            first = next(victim.tokens(timeout=600))
            fail["mid_stream_at_wedge"] = wedge["mid_stream"]
        for h in hs:
            while True:
                try:
                    outs.append(h.result(timeout=0.05))
                    break
                except TimeoutError:
                    require(time.perf_counter() - t0 < 600,
                            f"cluster {name}: no progress in 600 s")
                if failover:
                    now = time.perf_counter() - wedge["t"]
                    if "hung_seen_s" not in fail and \
                            replicas[0].health()["state"] == "hung":
                        fail["hung_seen_s"] = now
                    if "first_resubmit_s" not in fail and \
                            router.stats["resubmitted"] > 0:
                        fail["first_resubmit_s"] = now
        wall = time.perf_counter() - t0
        if failover:
            fail["served_after_hang_s"] = time.perf_counter() - wedge["t"]
            fail["hung_at_end"] = replicas[0].health()["state"] == "hung"
            fail["victim_resume_tokens"] = len(victim._resume_tokens or ())
            # the requests resumed on the survivor (their index in the
            # streams, seed wave first) with the prefix each resumed from
            resumed = {CL_TENANTS + j: list(h._resume_tokens)
                       for j, h in enumerate(hs)
                       if h._resume_tokens is not None}
            fail["victim"] = CL_TENANTS + hs.index(victim)
            fail["resumed_requests"] = sorted(resumed)
        stats = {k: (list(v) if isinstance(v, list) else v)
                 for k, v in router.stats.items()}
        per = []
        for i, srv in enumerate(replicas):
            st = srv.engine.stats
            per.append({"replica": i, "tokens": st["tokens_generated"],
                        "tokens_per_s": st["tokens_generated"] / wall,
                        "prefix_hit_tokens": st["prefix_hit_tokens"],
                        "prefill_tokens": st["prefill_tokens"],
                        "placements": stats["placements"][i]})
        errors = router.stop()
        torch.cuda.synchronize()
    outstanding = router.num_outstanding()
    launches = kernel_counts()
    L = models[0].config.num_hidden_layers
    steps = [{"mixed": sum(k == "mixed" for k, _ in log),
              "decode_iterations": sum(r for k, r in log if k == "decode")}
             for log in logs]
    hit = sum(p["prefix_hit_tokens"] for p in per)
    pre = sum(p["prefill_tokens"] for p in per)
    n_tok = sum(len(o.token_ids) for o in outs[CL_TENANTS:])
    arm = {"arm": name, "replicas": n, "policy": policy,
           "aggregate_tokens_per_s": n_tok / wall, "wall_s": wall,
           "seed_wave_s": seed_s, "per_replica": per,
           "affinity_hit_rate": hit / (hit + pre) if hit + pre else 0.0,
           "stats": stats, "steps": steps, "launches": launches,
           "plain_calls": dict(plain_calls), "stop_errors": len(errors),
           "outstanding_after_stop": outstanding,
           "finish_reasons": sorted({o.finish_reason for o in outs})}
    if syncs is not None:
        arm["step_begin_syncs"] = len(syncs)
        arm["step_begin_sync_messages"] = sorted(set(syncs))[:5]
    if failover:
        arm["failover"] = fail
    require(len(outs) == len(prompts) and all(
        o.finish_reason == "length" and len(o.token_ids) == CL_NEW
        for o in outs),
        f"cluster {name}: a request did not finish with its {CL_NEW} "
        f"tokens: {arm['finish_reasons']}")
    require(not errors and outstanding == 0,
            f"cluster {name}: stop gave {errors}, {outstanding} handles "
            f"outstanding")
    require(not plain_calls, f"cluster {name}: plain versions ran on the "
            f"card: {dict(plain_calls)}")
    require(all(s["mixed"] > 0 and s["decode_iterations"] > 0
                for s in steps),
            f"cluster {name}: a replica ran no mixed or no decode step: "
            f"{steps}")
    require(launches["b3_append"] == L * sum(s["mixed"] for s in steps)
            and launches["b2_decode"]
            == L * sum(s["decode_iterations"] for s in steps)
            and all(v == 0 for k, v in launches.items()
                    if k not in ("b2_decode", "b3_append")),
            f"cluster {name}: launches {launches} against {steps} x {L}")
    require(syncs is None or not syncs,
            f"cluster {name}: step_begin made {len(syncs or ())} "
            f"synchronizing calls")
    if failover:
        # each resumed stream continues from exactly what its caller had
        # consumed: the victim's one token, the others' none
        v = fail["victim"]
        require(len(resumed) == arm["stats"]["resumed"] >= 1
                and resumed.get(v) == [first]
                and all(list(outs[j].token_ids[:len(r)]) == r
                        for j, r in resumed.items()),
                f"cluster {name}: resumed {sorted(resumed)} against "
                f"stats {arm['stats']['resumed']}, victim {v} consumed "
                f"{first} and resumed from {resumed.get(v)}")
    for srv in replicas:
        del srv.engine.step_begin
    return arm, [list(o.token_ids) for o in outs]


def host_launch_us(dev, n=2000):
    """The host's microseconds a launch: ``n`` in-place adds on one
    element, timed on the host clock without waiting for the card."""
    x = torch.zeros(1, device=dev)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def run_cluster(dev):
    """The llama_serve_cluster rung's arms (CL_ARMS) over one model copy
    per replica: one replica twice, two under affinity, two under random
    placement, and two under affinity with replica 0 wedged mid-wave.
    Every arm's tokens are held to the no-cache forward, and each arm's
    streams to the first single arm's. Returns the arms' paged launches,
    summed."""
    t_phase = time.perf_counter()
    launch_us = [host_launch_us(dev)]
    models = [build_model(dev, num_hidden_layers=DENSE_LAYERS,
                          intermediate_size=DENSE_FF,
                          max_position_embeddings=CL_CAP)
              for _ in range(CL_REPLICAS)]
    prompts, warms = cluster_traffic(models[0].config.vocab_size)
    arms, toks = {}, {}
    for name, n, policy, failover in CL_ARMS:
        arms[name], toks[name] = cluster_arm(models, dev, prompts, warms,
                                             name, n, policy, failover)
        gc.collect()
        torch.cuda.empty_cache()
    launch_us.append(host_launch_us(dev))
    # the streams come seed wave first, which is the prompts' order; each
    # request's tokens against the no-cache forward over its own prefix
    out = collections.namedtuple("Out", "token_ids")
    greedy = {name: [greedy_check(models[0], dev, [p], [out(t)])
                     for p, t in zip(prompts, ts)]
              for name, ts in toks.items()}
    resumed = arms["failover"]["failover"]["resumed_requests"]
    greedy_sum = {name: dict(zip(("checked", "excused_near_ties",
                                  "mismatched"),
                                 map(sum, zip(*rows))))
                  for name, rows in greedy.items()}
    greedy_sum["failover_resumed"] = dict(zip(
        ("checked", "excused_near_ties", "mismatched"),
        map(sum, zip(*[greedy["failover"][j] for j in resumed]))))
    parts = {name: first_parting(models[0], dev, prompts, toks["single"],
                                 toks[name])
             for name in ("single_2", "cluster", "random", "failover")}
    del models
    gc.collect()
    torch.cuda.empty_cache()
    single, cluster = arms["single"], arms["cluster"]
    emit({"phase": "cluster", "requests": CL_REQUESTS, "tenants": CL_TENANTS,
          "sys_prompt_len": CL_SYS, "prompt_lens": [len(p) for p in prompts],
          "new_tokens": CL_NEW, "capacity": CL_CAP,
          "step_timeout_s": CL_STEP_TIMEOUT_S, "hang_s": CL_HANG_S,
          "host_launch_us": launch_us,
          "aggregate_tokens_per_s": {k: a["aggregate_tokens_per_s"]
                                     for k, a in arms.items()},
          "affinity_hit_rate": {k: a["affinity_hit_rate"]
                                for k, a in arms.items()},
          "placements": {k: a["stats"]["placements"]
                         for k, a in arms.items()},
          # two replicas share one card here: not a capacity claim
          "cluster_speedup_vs_single": cluster["aggregate_tokens_per_s"]
          / single["aggregate_tokens_per_s"],
          "token_exact": {k: not ps for k, ps in parts.items()},
          "partings": parts,
          "greedy": greedy_sum,
          "arms": arms, "margin": MARGIN,
          "seconds": time.perf_counter() - t_phase})
    for name, ps in parts.items():
        require(all(p["margin"] <= MARGIN for p in ps),
                f"cluster {name} arm parts from the single arm where the "
                f"margin exceeds {MARGIN}: {ps}")
    for name, g in greedy_sum.items():
        require(g["mismatched"] == 0, f"cluster {name}: {g['mismatched']} "
                f"greedy tokens disagree with the no-cache forward beyond "
                f"{MARGIN}")
    st = cluster["stats"]
    require(st["affinity_routed"] > 0 and all(st["placements"]),
            f"cluster arm: affinity_routed {st['affinity_routed']}, "
            f"placements {st['placements']}")
    require(cluster["affinity_hit_rate"] > arms["random"]["affinity_hit_rate"],
            f"cluster arm's hit rate {cluster['affinity_hit_rate']} is not "
            f"above the random arm's {arms['random']['affinity_hit_rate']}")
    fo = arms["failover"]
    require(fo["stats"]["evicted_hung"] >= 1 and fo["stats"]["resumed"] >= 1
            and fo["stats"]["replica_lost"] == 0,
            f"failover arm: evicted_hung {fo['stats']['evicted_hung']}, "
            f"resumed {fo['stats']['resumed']}, replica_lost "
            f"{fo['stats']['replica_lost']}")
    require("hung_seen_s" in fo["failover"],
            f"failover arm: replica 0 never read hung: {fo['failover']}")
    total = collections.Counter()
    for a in arms.values():
        total.update(a["launches"])
    return dict(total)


# ---------------------------------------------------------------------------
# (d-xii) disaggregated prefill/decode: the llama_serve_disagg rung
# ---------------------------------------------------------------------------

#: the rung's traffic and engines (bench.py:1511-1555, its defaults): the
#: 3-layer model at 7B widths (ff 11264, MHA, bf16, seed 0) with a rope
#: table of the capacity, one model behind both replicas; 4 trickle
#: streams of 64-token prompts with 64 new tokens each, then a flood of
#: 16 prompts of 249-263 tokens with 2 new tokens each; 8 slots, chunk
#: 256, block 64, capacity 512, paged, fused
DG_PROMPT, DG_NEW, DG_FLOOD, DG_FLOOD_NEW, DG_TRICKLE = 256, 64, 16, 2, 4
DG_CAP = -(-(DG_PROMPT + DG_NEW) // DENSE_CHUNK) * DENSE_CHUNK
DG_ROLES = {"prefill": [0], "decode": [1]}
#: (arm, roles, flood): the unflooded floor, both replicas taking
#: everything, and the role split
DG_ARMS = (("floor", None, False), ("mixed", None, True),
           ("disagg", DG_ROLES, True))
#: the wire check: a prompt whose one-token leg stages 5 blocks
DG_WIRE_PROMPT, DG_WIRE_REPS = 300, 5


def disagg_traffic(vocab):
    """The rung's flood and trickle prompts, then each arm's two 3-token
    warm prompts, drawn from one generator in the rung's order
    (bench.py:1530-1546)."""
    rng = np.random.default_rng(0)
    flood = [rng.integers(0, vocab, (DG_PROMPT - 7 + int(x),)).astype(
        np.int32) for x in rng.integers(0, 15, size=DG_FLOOD)]
    trickle = [rng.integers(0, vocab, (max(DG_PROMPT // 4, 4),)).astype(
        np.int32) for _ in range(DG_TRICKLE)]
    warms = [[rng.integers(0, vocab, (3,)).astype(np.int32)
              for _ in range(2)] for _ in DG_ARMS]
    return flood, trickle, warms


def disagg_engine(model, dev, **over):
    kw = dict(max_batch=DENSE_SLOTS, max_seq_len=DG_CAP,
              chunk_size=DENSE_CHUNK, cache_impl="paged", block_size=64,
              scheduler="fused", device=dev)
    kw.update(over)
    return LLMEngine(model, **kw)


def pool_drained(eng):
    """The end state of a paged engine: every block free or cached, no
    swap or export entry left, and the allocator audit."""
    saved = eng._debug_pool
    eng._debug_pool = True
    try:
        eng._check_pool_invariants()
    finally:
        eng._debug_pool = saved
    return (len(eng._free_blocks) + len(eng._lru) == eng.n_blocks
            and not eng._swap_store and not eng._export_store)


def disagg_arm(model, dev, flood, trickle, warms, name, roles, with_flood):
    """One arm of the rung: two warmed replicas behind a ReplicaRouter
    (``roles`` splits them, each with a FlightRecorder), the trickle
    streams submitted first and consumed on their own threads with each
    token's arrival stamped, then the flood. Gates: every request finishes
    with its tokens, the router stops with nothing outstanding, no plain
    version runs, and the replicas' B3 launches equal their mixed steps
    and their B2 launches their decode iterations, once a layer each.
    Returns the arm's line, the trickle and flood streams, and (split arm)
    the merged trace's events."""
    logs = [[], []]
    servers = []
    for i in range(2):
        eng = disagg_engine(model, dev)
        eng.generate([warms[i]], max_new_tokens=2)
        torch.cuda.synchronize()
        eng.reset()
        eng.reset_stats()
        begin = eng.step_begin

        def logged_begin(begin=begin, log=logs[i]):
            pending = begin()
            if pending is not None and pending.toks is not None:
                log.append((pending.kind, int(pending.toks.shape[0])))
            return pending

        eng.step_begin = logged_begin
        servers.append(AsyncLLMServer(
            eng, replica=i, max_queue_size=DG_FLOOD + DG_TRICKLE + 1,
            flight_recorder=FlightRecorder() if roles else None))
    router = ReplicaRouter(servers, roles=roles)
    stamps = [[] for _ in trickle]
    t_sub = [None] * len(trickle)

    def consume(h, out):
        for tok in h.tokens(timeout=600):
            out.append((time.perf_counter(), int(tok)))

    events = None
    reset_kernel_counts()
    with counting_plain() as plain_calls:
        router.start()
        t0 = time.perf_counter()
        threads = []
        for i, p in enumerate(trickle):
            t_sub[i] = time.perf_counter()
            h = router.submit(p, max_new_tokens=DG_NEW)
            th = threading.Thread(target=consume, args=(h, stamps[i]),
                                  daemon=True)
            th.start()
            threads.append(th)
        fh = [router.submit(p, max_new_tokens=DG_FLOOD_NEW)
              for p in flood] if with_flood else []
        fres = [h.result(timeout=600) for h in fh]
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        snap = router.snapshot()
        if roles:
            with tempfile.TemporaryDirectory() as tmpd:
                path = router.export_merged_trace(
                    os.path.join(tmpd, "disagg_trace.json"))
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
        errors = router.stop(timeout=120)
        torch.cuda.synchronize()
    outstanding = router.num_outstanding()
    launches = kernel_counts()
    L = model.config.num_hidden_layers
    steps = [{"mixed": sum(k == "mixed" for k, _ in log),
              "decode_iterations": sum(r for k, r in log if k == "decode")}
             for log in logs]
    gaps = [b[0] - a[0] for s in stamps for a, b in zip(s, s[1:])]
    ttfts = [s[0][0] - t for s, t in zip(stamps, t_sub) if s]
    trickle_toks = [[t for _, t in s] for s in stamps]
    flood_toks = [list(r.token_ids) for r in fres]
    n_tok = sum(map(len, trickle_toks)) + sum(map(len, flood_toks))
    st = router.stats
    migrated = st["kv_shipped"] + st["kv_ship_fallback"]
    dec = servers[1].engine.stats["prefill_tokens"]
    arm = {"arm": name, "roles": roles, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "decode_p50_ms": float(np.quantile(gaps, 0.5)) * 1e3,
           "decode_p99_ms": float(np.quantile(gaps, 0.99)) * 1e3,
           "ttft_p99_ms": float(np.quantile(ttfts, 0.99)) * 1e3,
           "kv_shipped": st["kv_shipped"],
           "kv_ship_fallback": st["kv_ship_fallback"],
           "kv_ship_abandoned": st["kv_ship_abandoned"],
           "ship_bytes": (snap.get("transport") or {}).get("ship_bytes", 0),
           "migration_latency": snap["migration_latency"],
           "migration_phases": snap["migration_phases"],
           "migrations_recorded": snap["migrations_recorded"],
           "decode_prefill_tokens": dec,
           "decode_reprefill_tokens": dec - migrated if roles else None,
           "placements": list(st["placements"]),
           "per_replica": [{k: s.engine.stats[k] for k in (
               "tokens_generated", "prefill_tokens", "kv_ship_out_blocks",
               "kv_ship_in_blocks", "kv_ship_out_bytes",
               "kv_ship_in_bytes", "swap_out_time_s", "swap_in_time_s")}
               for s in servers],
           "drained": [pool_drained(s.engine) for s in servers],
           "steps": steps, "launches": launches,
           "plain_calls": dict(plain_calls), "stop_errors": len(errors),
           "outstanding_after_stop": outstanding}
    require(all(len(t) == DG_NEW for t in trickle_toks) and all(
        r.finish_reason == "length" and len(r.token_ids) == DG_FLOOD_NEW
        for r in fres),
        f"disagg {name}: a request did not finish with its tokens: "
        f"{[len(t) for t in trickle_toks]}, "
        f"{sorted({r.finish_reason for r in fres})}")
    require(not errors and outstanding == 0,
            f"disagg {name}: stop gave {errors}, {outstanding} handles "
            f"outstanding")
    require(not plain_calls, f"disagg {name}: plain versions ran on the "
            f"card: {dict(plain_calls)}")
    require(launches["b3_append"] == L * sum(s["mixed"] for s in steps)
            and launches["b2_decode"]
            == L * sum(s["decode_iterations"] for s in steps)
            and launches["b3_append"] > 0 and launches["b2_decode"] > 0
            and all(v == 0 for k, v in launches.items()
                    if k not in ("b2_decode", "b3_append")),
            f"disagg {name}: launches {launches} against {steps} x {L}")
    require(all(arm["drained"]),
            f"disagg {name}: a pool did not drain (blocks free or cached, "
            f"swap and export stores empty, invariants): {arm['drained']}")
    for srv in servers:
        del srv.engine.step_begin
    return arm, trickle_toks, flood_toks, events


def wire_check(model, dev, quant):
    """The PTKV wire on the card: a one-token leg of a DG_WIRE_PROMPT-token
    prompt stages 5 blocks on one engine (``quant`` pool), the entry is
    serialized, deserialized into pinned memory and imported into a second
    engine, whose resume restores it; the restored blocks (payload and
    scales) must equal the source's blocks bit for bit. Serialize and
    deserialize timed on the host (median of DG_WIRE_REPS after one), in
    GB/s of wire bytes."""
    src = disagg_engine(model, dev, kv_cache_dtype=quant)
    dst = disagg_engine(model, dev, kv_cache_dtype=quant)
    p = np.random.default_rng(7).integers(
        0, model.config.vocab_size, (DG_WIRE_PROMPT,)).astype(np.int32)
    staged, restored = [], []
    export = src._export_slot_kv

    def watched_export(b, slot):
        nb = (slot.prefill_pos + len(slot.generated) - 1) \
            // src.block_size + 1
        staged.append(list(src._slot_blocks[b][:nb]))
        export(b, slot)

    src._export_slot_kv = watched_export
    restore = dst._restore_blocks

    def watched_restore(entry, lo, blocks):
        restore(entry, lo, blocks)
        ok = True
        for a, b in zip(*(e._tier_pools()[0] + (e._tier_pools()[1] or ())
                          for e in (src, dst))):
            ok = ok and torch.equal(a[staged[0][lo:lo + len(blocks)]],
                                    b[blocks])
        restored.append((lo, len(blocks), ok))

    dst._restore_blocks = watched_restore
    rid = src.add_request(p, max_new_tokens=1, export_kv=True)
    while src.has_unfinished():
        src.step()
    tok = src.finished_outputs.pop(rid).token_ids[0]
    t0 = time.perf_counter()
    entry = src.export_kv(rid)
    export_ms = (time.perf_counter() - t0) * 1e3
    defs = pool_treedefs(dst)
    ser, des = [], []
    for _ in range(DG_WIRE_REPS + 1):
        t0 = time.perf_counter()
        wire = serialize_entry(entry)
        t1 = time.perf_counter()
        back = deserialize_entry(wire, defs, pin_memory=True)
        t2 = time.perf_counter()
        ser.append(t1 - t0)
        des.append(t2 - t1)
    imported = dst.import_kv(back)
    dst.add_request(p, max_new_tokens=2, request_id=rid,
                    committed_tokens=[tok])
    while dst.has_unfinished():
        dst.step()
    out = dst.finished_outputs.pop(rid)
    torch.cuda.synchronize()
    line = {"kv_cache_dtype": quant or "bf16", "blocks": entry["n_blocks"],
            "entry_bytes": entry["nbytes"], "wire_bytes": len(wire),
            "export_wait_ms": export_ms,
            "serialize_ms": median(ser[1:]) * 1e3,
            "deserialize_ms": median(des[1:]) * 1e3,
            "serialize_gb_per_s": len(wire) / median(ser[1:]) / 1e9,
            "deserialize_gb_per_s": len(wire) / median(des[1:]) / 1e9,
            "pinned": bool(back["kv"].is_pinned()), "imported": imported,
            "restores": restored, "stitch_prefill_tokens":
                dst.stats["prefill_tokens"],
            "kv_ship_in_blocks": dst.stats["kv_ship_in_blocks"],
            "finish_reason": out.finish_reason,
            "drained": [pool_drained(e) for e in (src, dst)]}
    require(imported and entry["n_blocks"] == 5 and line["pinned"],
            f"disagg wire {line['kv_cache_dtype']}: not staged as 5 pinned "
            f"blocks and imported: {line}")
    require(len(restored) == 1 and restored[0][:2] == (0, 5)
            and restored[0][2],
            f"disagg wire {line['kv_cache_dtype']}: the restored blocks "
            f"differ from the source's: {restored}")
    # the output carries the committed leg token before the 2 new ones
    require(line["stitch_prefill_tokens"] == 1 and len(out.token_ids) == 3
            and all(line["drained"]),
            f"disagg wire {line['kv_cache_dtype']}: the resume did not "
            f"stitch one position and drain: {line}")
    del src, dst, entry, back, wire
    return line


def run_disagg(dev):
    """The llama_serve_disagg rung's arms (DG_ARMS) over one model behind
    two replicas, and the card-side wire check (bf16 and int8 entries of
    5 blocks). Gates: every arm's trickle and flood streams equal the
    floor's and the mixed arm's up to a reported near-tie, and every token
    passes the greedy check; the split arm ships all 20 legs with no
    fallback, its decode replica prefills one stitch token a migration,
    its migration phases serialize, transport, import and place sum to
    0.5-1.05x of the mean migration latency (the rung's own check,
    bench.py:1630-1641), 20 migrations are recorded and its merged trace
    holds one flow a migration; the wire check restores bit for bit.
    Returns the phase's paged launches, summed."""
    t_phase = time.perf_counter()
    model = build_model(dev, num_hidden_layers=DENSE_LAYERS,
                        intermediate_size=DENSE_FF,
                        max_position_embeddings=DG_CAP)
    flood, trickle, warms = disagg_traffic(model.config.vocab_size)
    total = collections.Counter()
    reset_kernel_counts()
    wire = [wire_check(model, dev, q) for q in (None, "int8")]
    total.update(kernel_counts())
    gc.collect()
    torch.cuda.empty_cache()
    arms, toks, trace = {}, {}, None
    for (name, roles, with_flood), w in zip(DG_ARMS, warms):
        arms[name], tr, fl, ev = disagg_arm(model, dev, flood, trickle, w,
                                            name, roles, with_flood)
        toks[name] = (tr, fl)
        trace = ev if ev is not None else trace
        total.update(arms[name]["launches"])
        gc.collect()
        torch.cuda.empty_cache()
    out = collections.namedtuple("Out", "token_ids")
    greedy = {name: greedy_check(model, dev, trickle + flood[:len(fl)],
                                 [out(t) for t in tr + fl])
              for name, (tr, fl) in toks.items()}
    parts = {"mixed_trickle": first_parting(
        model, dev, trickle, toks["floor"][0], toks["mixed"][0]),
        "disagg_trickle": first_parting(
        model, dev, trickle, toks["floor"][0], toks["disagg"][0]),
        "disagg_flood": first_parting(
        model, dev, flood, toks["mixed"][1], toks["disagg"][1])}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dis = arms["disagg"]
    mp = dis["migration_phases"]
    phase_sum = sum(mp[p]["mean_s"] for p in ("serialize", "transport",
                                              "import", "place") if p in mp)
    mig_mean = dis["migration_latency"]["mean_s"]
    flows = [e for e in trace if e.get("ph") == "s"
             and e.get("name") == FLOW_EVENT_NAME]
    mig_spans = [e for e in trace if e.get("cat") == "migration"]
    emit({"phase": "disagg", "flood_requests": DG_FLOOD,
          "trickle_requests": DG_TRICKLE, "new_tokens": DG_NEW,
          "flood_new_tokens": DG_FLOOD_NEW,
          "flood_prompt_lens": [len(p) for p in flood],
          "trickle_prompt_len": len(trickle[0]), "capacity": DG_CAP,
          "tokens_per_s": {k: a["tokens_per_s"] for k, a in arms.items()},
          "decode_p99_ms": {k: a["decode_p99_ms"] for k, a in arms.items()},
          "ttft_p99_ms": {k: a["ttft_p99_ms"] for k, a in arms.items()},
          # two replicas share one card and one stream here: not a claim
          # about what disaggregation buys
          "disagg_p99_vs_mixed": dis["decode_p99_ms"]
          / arms["mixed"]["decode_p99_ms"],
          "migration_phase_sum_s": phase_sum,
          "migration_latency_mean_s": mig_mean,
          "ship_bytes_per_migration": dis["ship_bytes"]
          / max(dis["kv_shipped"], 1),
          "trace_flows": len(flows), "trace_migration_spans": len(mig_spans),
          "token_exact": {k: not ps for k, ps in parts.items()},
          "partings": parts,
          "greedy": {k: dict(zip(("checked", "excused_near_ties",
                                  "mismatched"), g))
                     for k, g in greedy.items()},
          "wire": wire, "arms": arms, "margin": MARGIN,
          "seconds": time.perf_counter() - t_phase})
    for name, ps in parts.items():
        require(all(p["margin"] <= MARGIN for p in ps),
                f"disagg {name} parts where the margin exceeds {MARGIN}: "
                f"{ps}")
    for name, (_, _, mismatched) in greedy.items():
        require(mismatched == 0, f"disagg {name}: {mismatched} greedy "
                f"tokens disagree with the no-cache forward beyond {MARGIN}")
    n_legs = DG_FLOOD + DG_TRICKLE
    require(dis["kv_shipped"] == n_legs and dis["kv_ship_fallback"] == 0
            and dis["kv_ship_abandoned"] == 0,
            f"disagg arm: shipped {dis['kv_shipped']}, fell back "
            f"{dis['kv_ship_fallback']}, abandoned "
            f"{dis['kv_ship_abandoned']} of {n_legs} legs")
    require(dis["decode_reprefill_tokens"] == 0,
            f"disagg arm: the decode replica prefilled "
            f"{dis['decode_prefill_tokens']} tokens for "
            f"{dis['kv_shipped']} migrations")
    require(0.5 * mig_mean <= phase_sum <= 1.05 * mig_mean,
            f"disagg arm: migration phases sum to {phase_sum} s against a "
            f"mean migration of {mig_mean} s: {mp}")
    require(dis["migrations_recorded"] == n_legs and len(flows) == n_legs
            and len(mig_spans) == 4 * n_legs,
            f"disagg arm: {dis['migrations_recorded']} migrations recorded, "
            f"{len(flows)} flows and {len(mig_spans)} phase spans in the "
            f"merged trace, for {n_legs} legs")
    require(all(a["kv_shipped"] == 0 and a["placements"][0] > 0
                and a["placements"][1] > 0 for n, a in arms.items()
                if n != "disagg"),
            f"disagg: a mixed-placement arm shipped or left a replica idle: "
            f"{[(n, a['kv_shipped'], a['placements']) for n, a in arms.items()]}")
    return dict(total)


# ---------------------------------------------------------------------------
# (d-xiii) sampling: threefry keys, the filtered categorical, sampled
# generate and sampled serving
# ---------------------------------------------------------------------------

#: known answers read off jax 0.9.0 on the CPU (x64 on, as the reference
#: runs it; the partitionable threefry mode): Random123's threefry2x32
#: vectors, raw keys, folds, a split, and PRNGKey(0)'s first bits and
#: float32 uniforms
PRNG_KAT = {
    "threefry": [((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                  (0xC4923A9C, 0x483DF7A0)),
                 ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                 ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                  (0x1CB996FC, 0xBB002BE7))],
    "prng_key": {0: [0, 0], 7: [0, 7], 2 ** 31 - 1: [0, 2 ** 31 - 1],
                 2 ** 32 + 5: [1, 5]},
    "fold_in_7_3": [276534068, 1641862660],
    "fold_in_7_11_523": [1591046783, 308682254],
    "split_42_3": [[1832780943, 270669613], [64467757, 2916123636],
                   [2465931498, 255383827]],
    "bits_0_4": [4070199207, 4202968722, 1427181096, 2012915765],
    "uniform_0_3": [float.fromhex("0x1.e5349cp-1"),
                    float.fromhex("0x1.f5086cp-1"),
                    float.fromhex("0x1.544438p-2")],
}
SAMPLED = dict(temperature=0.8, top_p=0.9)
SAMPLE_TOP_K = 50          # generate's and the distribution check's top-k
SAMPLE_SEED = 7            # the serving engines' sampling_seed
SAMPLE_NEW = 64
SAMPLE_DRAWS = 20000
SAMPLE_CHI2_P = 1e-3
SAMPLE_NEAR_TIE_SHARE = 0.05
SAMPLE_SWAP_BLOCKS = 80    # about half of eight resident requests' demand
SAMPLE_LAYERS = 3          # the serving arms' cut (step 4, but the fused)


def _bits_equal(a, b):
    return bool(torch.equal(a.cpu(), b.cpu()))


def prng_on_card(dev):
    """Step 1: the known answers computed on the card, then random bits
    and uniforms over [8, 32000] and [8, 6, 32000] (one key, and a key a
    row over [32000]) on the card against the same functions on CPU
    tensors, bit for bit; the Gumbel noise's largest ulp apart is
    reported."""
    kat = PRNG_KAT
    ok = {}
    ok["threefry"] = all(
        [int(w) for w in prng.threefry_2x32(
            torch.tensor(k[0], device=dev), torch.tensor(k[1], device=dev),
            torch.tensor([x[0]], device=dev),
            torch.tensor([x[1]], device=dev))] == list(y)
        for k, x, y in kat["threefry"])
    ok["prng_key"] = all(prng.PRNGKey(s, dev).tolist() == w
                         for s, w in kat["prng_key"].items())
    k7 = prng.PRNGKey(7, dev)
    ok["fold_in"] = prng.fold_in(k7, 3).tolist() == kat["fold_in_7_3"] and \
        prng.fold_in(prng.fold_in(k7, 11), 523).tolist() == \
        kat["fold_in_7_11_523"]
    ok["split"] = prng.split(prng.PRNGKey(42, dev), 3).tolist() == \
        kat["split_42_3"]
    k0 = prng.PRNGKey(0, dev)
    ok["bits"] = prng.random_bits(k0, (4,)).tolist() == kat["bits_0_4"]
    ok["uniform"] = prng.uniform(k0, (3,)).tolist() == kat["uniform_0_3"]
    same, gumbel_ulps = {}, {}
    key_c = prng.fold_in(prng.PRNGKey(SAMPLE_SEED), 1)
    rows_c = prng.fold_in(prng.split(key_c, 8)[:, None],
                          torch.arange(6)[None])           # [8, 6, 2]
    for name, kc, shape in (("one_key_8x32000", key_c, (8, 32000)),
                            ("one_key_8x6x32000", key_c, (8, 6, 32000)),
                            ("row_keys_8x32000", prng.split(key_c, 8),
                             (32000,)),
                            ("row_keys_8x6x32000", rows_c, (32000,))):
        kg = kc.to(dev)
        same[name] = _bits_equal(prng.random_bits(kg, shape),
                                 prng.random_bits(kc, shape)) and \
            _bits_equal(prng.uniform(kg, shape).view(torch.int32),
                        prng.uniform(kc, shape).view(torch.int32))
        g_gpu = prng.gumbel(kg, shape).cpu().view(torch.int32).long()
        g_cpu = prng.gumbel(kc, shape).view(torch.int32).long()
        gumbel_ulps[name] = int((g_gpu - g_cpu).abs().max())
    line = {"known_answers": ok, "card_equals_cpu": same,
            "gumbel_max_ulps_card_vs_cpu": gumbel_ulps}
    require(all(ok.values()), f"sampling: PRNG known answers on the card: "
            f"{ok}")
    require(all(same.values()), f"sampling: bits/uniforms on the card "
            f"differ from the CPU's: {same}")
    return line


def sample_distribution(dev):
    """Step 2: one fixed logits row (seeded, V 32000), top_k 50, top_p
    0.9, temperature 0.8: SAMPLE_DRAWS draws through the engine's
    ``_sample_next`` on the card under distinct ``fold_in`` positions of
    one rid; no draw outside the keep set, and a chi-square against the
    filtered softmax (expected counts under 5 pooled) at p >
    SAMPLE_CHI2_P."""
    from scipy import stats
    V = 32000
    rng = np.random.default_rng(13)
    row = torch.from_numpy((rng.standard_normal(V) * 2).astype(np.float32)) \
        .to(dev)
    t = torch.tensor(SAMPLED["temperature"], device=dev)
    p = torch.tensor(SAMPLED["top_p"], device=dev)
    filtered = tllama._filter_logits(row[None], t, SAMPLE_TOP_K, p, True)[0]
    keep = torch.isfinite(filtered).cpu()
    probs = torch.softmax(filtered.double(), dim=-1).cpu()
    base = prng.PRNGKey(SAMPLE_SEED, dev)
    counts = torch.zeros(V, dtype=torch.int64, device=dev)
    chunk = 1000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, SAMPLE_DRAWS, chunk):
        n = min(chunk, SAMPLE_DRAWS - lo)
        samp = tle._Sampling(base, torch.full((n,), SAMPLED["temperature"],
                                              device=dev),
                             torch.full((n,), SAMPLED["top_p"], device=dev),
                             torch.full((n,), 3, dtype=torch.int64,
                                        device=dev), SAMPLE_TOP_K)
        toks = tle._sample_next(row.expand(n, V), samp,
                                torch.arange(lo, lo + n, device=dev))
        counts += torch.bincount(toks.long(), minlength=V)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    counts = counts.cpu()
    outside = int(counts[~keep].sum())
    obs = counts[keep].double().numpy()
    exp = probs[keep].numpy() * SAMPLE_DRAWS
    small = exp < 5
    if small.any():
        obs = np.append(obs[~small], obs[small].sum())
        exp = np.append(exp[~small], exp[small].sum())
    exp *= obs.sum() / exp.sum()
    chi2, pval = stats.chisquare(obs, exp)
    line = {"draws": SAMPLE_DRAWS, "keep_set": int(keep.sum()),
            "bins": len(obs), "outside_keep_set": outside,
            "chi2": float(chi2), "p_value": float(pval),
            "draw_s": draw_s}
    require(outside == 0, f"sampling: {outside} draws outside the keep set")
    require(pval > SAMPLE_CHI2_P, f"sampling: chi-square p {pval} <= "
            f"{SAMPLE_CHI2_P}: {line}")
    return line


def _scores(rows, key, shape, temp, top_k, top_p):
    """Re-sample ``rows [R, V]`` (no-cache logits, float32, on the CPU)
    under ``key`` (one key over the block, or ``[R, 2]`` a key a row with
    ``shape`` (V,)) as the sampler does. Returns the tokens, the
    unfiltered perturbed scores (scaled logits plus the Gumbel noise),
    the scaled logits and each row's filter edge (its smallest kept
    scaled logit)."""
    t = torch.tensor(temp)
    f = tllama._filter_logits(rows, t, top_k, torch.tensor(top_p), True)
    noise = prng.gumbel(key, shape)
    scaled = rows.float() / t
    cut = f.masked_fill(~torch.isfinite(f), float("inf")).amin(dim=-1)
    return torch.argmax(f + noise, dim=-1), scaled + noise, scaled, cut


def _explain(raw, scaled, cut, a, b):
    """Why tokens ``a`` and ``b`` (a token a row) may part: their
    perturbed scores' gap, and the nearer one's distance to the filter's
    edge, where a bf16 rounding moves a token in or out of the top-k or
    the nucleus. Either under MARGIN is a near-tie; inf where a == b."""
    pick = lambda x, tok: x.gather(1, tok[:, None])[:, 0]   # noqa: E731
    gap = (pick(raw, a) - pick(raw, b)).abs()
    edge = torch.minimum((pick(scaled, a) - cut).abs(),
                         (pick(scaled, b) - cut).abs())
    inf = torch.full_like(gap, float("inf"))
    return torch.where(a == b, inf, gap), torch.where(a == b, inf, edge)


def _tally(got, want, gap, edge, margin=MARGIN):
    """Counts of a checked block of tokens: every token, those that differ
    at a near-tie (a perturbed gap or an edge distance under ``margin``)
    and those that differ otherwise (unexplained)."""
    diff = got != want
    near = (gap < margin) | (edge < margin)
    return {"checked": int(got.numel()), "near_ties": int((diff & near).sum()),
            "unexplained": int((diff & ~near).sum()),
            "parted": [[round(float(g), 5), round(float(e), 5)]
                       for g, e in zip(gap[diff], edge[diff])]}


def _add_tally(a, b):
    """Sum two tallies (the ``parted`` lists, (gap, edge) of each token
    that differs, joined up to 16)."""
    out = {k: a.get(k, 0) + b[k] for k in b if k != "parted"}
    out["parted"] = (a.get("parted", []) + b["parted"])[:16]
    return out


def sampled_generate(model, dev):
    """Step 3: sampled ``generate`` at B 8, prompt 512, SAMPLE_NEW new
    tokens, temperature 0.8, top_k 50, top_p 0.9, over the static and the
    paged cache of the 32-layer model (after a short warm call), the
    generator at (SAMPLE_SEED, 0) before each. Gates: B1 once a layer in
    the prefill, B2 once a layer a step on the paged arm (none on the
    static), no plain version, no synchronizing call; then the
    teacher-forced check: the no-cache forward over prompt + output on
    the card, each position re-sampled on the CPU under the same key
    chain (``fold_in(PRNGKey(7), 1)``, split once a step); a token may
    differ only at a near-tie (:func:`_explain`), and those near-ties are
    at most SAMPLE_NEAR_TIE_SHARE of the tokens."""
    ids = gen_ids(model.config.vocab_size).to(dev)
    L = model.config.num_hidden_layers
    kw = dict(temperature=SAMPLED["temperature"], top_k=SAMPLE_TOP_K,
              top_p=SAMPLED["top_p"])
    arms, launches = {}, collections.Counter()
    for cache_impl in ("static", "paged"):
        model.generate(ids, max_new_tokens=GEN_SHORT, cache_impl=cache_impl,
                       **kw)
        torch.cuda.synchronize()
        trandom.default_generator.set_state((SAMPLE_SEED, 0))
        reset_kernel_counts()
        flash_attention_fwd.launches = 0
        syncs = []
        with counting_plain() as plain:
            t0 = time.perf_counter()
            with sync_watch(syncs):
                out = model.generate(ids, max_new_tokens=SAMPLE_NEW,
                                     cache_impl=cache_impl, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {"b1_flash": flash_attention_fwd.launches,
                  **kernel_counts(), "b8_int4": int4_matmul.launches}
        launches.update({"b1": counts["b1_flash"],
                         "b2_decode": counts["b2_decode"]})
        toks = out.cpu()
        # teacher-forced: the no-cache forward's rows for every token
        with torch.no_grad():
            seq = torch.cat([ids, out[:, :-1]], dim=1)
            rows = model(seq)[:, GEN_PROMPT - 1:].float().cpu()
        rkey = prng.fold_in(prng.PRNGKey(SAMPLE_SEED), 1)
        tally = {}
        for i in range(SAMPLE_NEW):
            rkey, sub = prng.split(rkey)
            want, raw, scaled, cut = _scores(
                rows[:, i], sub, rows[:, i].shape, kw["temperature"],
                SAMPLE_TOP_K, kw["top_p"])
            got = toks[:, i]
            tally = _add_tally(tally, _tally(
                got, want, *_explain(raw, scaled, cut, got, want)))
        arm = {"cache_impl": cache_impl, "wall_s": wall,
               "tokens_per_s": GEN_B * SAMPLE_NEW / wall,
               "launches": counts, "plain_calls": dict(plain),
               "syncs": len(syncs), "sync_messages": sorted(set(syncs))[:5],
               "near_tie_share": tally["near_ties"] / tally["checked"],
               **tally}
        arms[cache_impl] = arm
        b2 = L * (SAMPLE_NEW - 1) if cache_impl == "paged" else 0
        require(tuple(toks.shape) == (GEN_B, SAMPLE_NEW),
                f"sampled generate {cache_impl}: shape {tuple(toks.shape)}")
        require(counts["b1_flash"] == L and counts["b2_decode"] == b2 and
                not plain and not syncs and all(
                    n == 0 for k, n in counts.items()
                    if k not in ("b1_flash", "b2_decode")),
                f"sampled generate {cache_impl}: {arm}")
        require(arm["unexplained"] == 0 and
                arm["near_tie_share"] <= SAMPLE_NEAR_TIE_SHARE,
                f"sampled generate {cache_impl}: teacher-forced check "
                f"{tally}")
    return arms, launches


def _stream_check(model, dev, prompts, streams, sampling, top_k):
    """Each request's tokens against a no-cache forward over its prefix:
    greedy requests by the argmax's margin, sampled ones re-sampled on the
    CPU under the serving engines' per-(rid, position) keys
    ``fold_in(fold_in(PRNGKey(SAMPLE_SEED), rid), position)`` (rid = the
    request's index, as a fresh server numbers them). Returns the tallies
    of the greedy and the sampled half."""
    base = prng.PRNGKey(SAMPLE_SEED)
    tallies = {"greedy": {}, "sampled": {}}
    with torch.no_grad():
        for rid, (p, toks, smp) in enumerate(zip(prompts, streams,
                                                 sampling)):
            seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
            rows = model(torch.from_numpy(seq[None]).to(dev))[0, len(p) - 1:]
            rows = rows.float().cpu()
            got = torch.tensor(toks)
            if not smp:
                top2 = torch.topk(rows, 2, dim=-1)
                margin = top2.values[:, 0] - top2.values[:, 1]
                t = _tally(got, top2.indices[:, 0], margin,
                           torch.full_like(margin, float("inf")))
                tallies["greedy"] = _add_tally(tallies["greedy"], t)
                continue
            pos = torch.arange(len(p), len(p) + len(toks))
            keys = prng.fold_in(prng.fold_in(base, rid), pos)
            want, raw, scaled, cut = _scores(
                rows, keys, (rows.shape[-1],), smp["temperature"], top_k,
                smp["top_p"])
            tallies["sampled"] = _add_tally(tallies["sampled"], _tally(
                got, want, *_explain(raw, scaled, cut, got, want)))
    return tallies


def _sampled_parting(model, dev, prompts, want, got, sampling, top_k):
    """Where two arms' streams part: per request that differs, the first
    step and, on the no-cache forward over the prompt and the common
    prefix, the logits' top-1/top-2 margin (greedy) or the two tokens'
    :func:`_explain` (sampled). Under MARGIN is a near-tie: the arms'
    bf16 products round apart."""
    base = prng.PRNGKey(SAMPLE_SEED)
    parts = []
    with torch.no_grad():
        for rid, (p, a, b, smp) in enumerate(zip(prompts, want, got,
                                                 sampling)):
            if a == b:
                continue
            n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            seq = np.concatenate([p, np.asarray(a[:n], np.int32)])
            row = model(torch.from_numpy(seq[None]).to(dev))[0, -1].float()
            row = row.cpu()[None]
            part = {"request": rid, "step": n, "sampled": bool(smp)}
            if n >= min(len(a), len(b)):
                part.update(gap=float("inf"), edge=float("inf"))
            elif not smp:
                top2 = torch.topk(row[0], 2).values
                part.update(gap=float(top2[0] - top2[1]), edge=float("inf"))
            else:
                key = prng.fold_in(prng.fold_in(base, rid), len(p) + n)
                _, raw, scaled, cut = _scores(
                    row, key[None], (row.shape[-1],), smp["temperature"],
                    top_k, smp["top_p"])
                gap, edge = _explain(raw, scaled, cut, torch.tensor([a[n]]),
                                     torch.tensor([b[n]]))
                part.update(gap=float(gap[0]), edge=float(edge[0]))
            part["near_tie"] = part["gap"] < MARGIN or part["edge"] < MARGIN
            parts.append(part)
    return parts


def sampling_arm_model(dev):
    return build_model(dev, num_hidden_layers=SAMPLE_LAYERS)


def sampled_serving(model, dev):
    """Step 4: the (d) serving prompts through AsyncLLMServer, every other
    one sampled (0.8 / 0.9, the engine's top_k 0: the full-sort nucleus),
    the rest greedy, every engine at ``sampling_seed=SAMPLE_SEED``. The
    fused paged arm on the 32-layer model passes the stream check (greedy
    margin, sampled teacher-forced, near-tie share at most
    SAMPLE_NEAR_TIE_SHARE). On a 3-layer model at the same widths the
    arms fused (the base), legacy, ``readout_stride=8``,
    ``speculative_k=6`` (fused grants over a bf16 paged pool), the legacy
    dense scan (``speculative_k=6``), a SAMPLE_SWAP_BLOCKS-block pool
    with ``kv_host_swap=True`` and an int8 pool: each arm's streams equal
    the base's up to a first parting at a near-tie (the int8 arm's drift
    is reported, not gated, as (d'')'s). serve_engine gates every arm on
    its tokens, no synchronizing call in ``step_begin``, no plain version
    and a healthy server; the paged arms also on their launches."""
    prompts = serving_prompts(model.config.vocab_size)
    sampling = [SAMPLED if i % 2 else {} for i in range(len(prompts))]
    total = collections.Counter()
    full = 8 * 2048 // 64
    arm32, toks32 = serve_arm(model, dev, prompts, None, full,
                              name="fused_32", sampling=sampling,
                              sampling_seed=SAMPLE_SEED)
    total.update(arm32["launches"])
    check32 = _stream_check(model, dev, prompts, toks32, sampling, 0)
    gc.collect()
    torch.cuda.empty_cache()
    m3 = sampling_arm_model(dev)
    arms, toks = {}, {}
    paged = dict(base=dict(), legacy=dict(scheduler="legacy"),
                 swap=dict(kv_host_swap=True),
                 int8=dict(kv_cache_dtype="int8"))
    blocks = dict(swap=SAMPLE_SWAP_BLOCKS)
    for name, kw in paged.items():
        q = kw.pop("kv_cache_dtype", None)
        arms[name], toks[name] = serve_arm(
            m3, dev, prompts, q, blocks.get(name, full), name=name,
            burst=name == "swap", sampling=sampling, tier=name == "swap",
            sampling_seed=SAMPLE_SEED, **kw)
        total.update(arms[name]["launches"])
        gc.collect()
        torch.cuda.empty_cache()
    L3 = SAMPLE_LAYERS
    for name, kw in (("stride8", dict(readout_stride=8)),
                     ("spec6", dict(speculative_k=6))):
        eng = make_fused_engine(m3, dev, sampling_seed=SAMPLE_SEED, **kw)
        arms[name], outs = serve_engine(eng, prompts, name,
                                        sampling=sampling)
        toks[name] = [list(o.token_ids) for o in outs]
        c = arms[name]["launches"]
        total.update(c)
        if name == "stride8":
            ok = c["b2_decode"] % L3 == 0 and c["b2_decode"] > 0 and \
                c["b3_append"] == arms[name]["mixed_steps"] * L3
        else:
            ok = c["b2_decode"] == 0 and c["b3_append"] > 0 and \
                c["b3_append"] % L3 == 0 and \
                eng.stats["spec_proposed_tokens"] > 0
        require(ok and all(n == 0 for k, n in c.items()
                           if k not in ("b2_decode", "b3_append")),
                f"sampled serving {name}: launches {c}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    eng = LLMEngine(m3, max_batch=8, chunk_size=256, max_seq_len=2048,
                    speculative_k=6, sampling_seed=SAMPLE_SEED, device=dev)
    arms["legacy_scan"], outs = serve_engine(eng, prompts, "legacy_scan",
                                             sampling=sampling)
    toks["legacy_scan"] = [list(o.token_ids) for o in outs]
    require(all(n == 0 for n in arms["legacy_scan"]["launches"].values())
            and eng.stats["spec_proposed_tokens"] > 0,
            f"sampled serving legacy_scan: {arms['legacy_scan']['launches']}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    sw = arms["swap"]
    require(sw["preemptions"] >= 1 and sw["tier"]["kv_swap_in_blocks"] >= 1
            and sw["tier"]["swap_store_empty"]
            and sw["tier"]["blocks_free_or_cached"],
            f"sampled serving swap: {sw['preemptions']} preemptions, tier "
            f"{sw['tier']}")
    parts = {name: _sampled_parting(m3, dev, prompts, toks["base"],
                                    toks[name], sampling, 0)
             for name in toks if name not in ("base", "int8")}
    base_check = _stream_check(m3, dev, prompts, toks["base"], sampling, 0)
    del m3
    gc.collect()
    torch.cuda.empty_cache()
    for name in arms:
        arms[name].pop("stage_shares", None)
    line = {"fused_32": {**arm32, "check": check32},
            "arms_3_layers": arms, "base_check": base_check,
            "partings": parts,
            "int8_drift_vs_base": drift(toks["base"], toks["int8"]),
            "token_exact": {k: not p for k, p in parts.items()}}
    for name, chk in (("fused_32", check32), ("base", base_check)):
        n = chk["sampled"]
        require(chk["greedy"]["unexplained"] == 0 and n["unexplained"] == 0
                and n["near_ties"] <= SAMPLE_NEAR_TIE_SHARE * n["checked"],
                f"sampled serving {name}: stream check {chk}")
    for name, ps in parts.items():
        require(all(p["near_tie"] for p in ps),
                f"sampled serving {name} parts from the base beyond a "
                f"near-tie: {ps}")
    return line, dict(total)


def sampler_cost(model, dev):
    """Step 5 (information): decode-step ms and tokens/s of a fused paged
    engine on the 32-layer model, 8 requests of the generate prompts past
    their ramp, greedy and then sampled, in one run; one step of each
    traced (device busy ms and device events a step); and the sampler
    alone at B 8 (``_sample_next`` with the engine's top_k 0 and with
    top_k 50): its device ms (CUDA events) and its launches (traced)."""
    ids = gen_ids(model.config.vocab_size)
    out = {}
    for mode, smp in (("greedy", {}), ("sampled", SAMPLED)):
        eng = make_fused_engine(model, dev, sampling_seed=SAMPLE_SEED)
        for r in ids.numpy():
            eng.add_request(r.astype(np.int32), max_new_tokens=64, **smp)
        while any(s is None or s.ramping for s in eng.slots):
            eng.step()
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(8):
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        win = device_breakdown(prof, wall, 1)
        ms = float(np.median(walls)) * 1e3
        out[mode] = {"decode_step_ms_median": ms,
                     "tokens_per_s": GEN_B / ms * 1e3,
                     "traced_step": win}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    logits = torch.randn((GEN_B, model.config.vocab_size), device=dev)
    lens = torch.full((GEN_B,), 600, dtype=torch.int32, device=dev)
    alone = {}
    for top_k in (0, SAMPLE_TOP_K):
        samp = tle._Sampling(prng.PRNGKey(SAMPLE_SEED, dev),
                             torch.full((GEN_B,), 0.8, device=dev),
                             torch.full((GEN_B,), 0.9, device=dev),
                             torch.arange(GEN_B, device=dev), top_k)

        def fn():
            tle._sample_next(logits, samp, lens)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        win = device_breakdown(prof, 1.0, 1)
        # a call enqueues ~580 launches (~13 ms of host): over 5 reps the
        # spin still holds the card while the host enqueues, and one call's
        # launches fit CUDA's launch queue, so the host never waits
        alone[f"top_k_{top_k}"] = {
            "device_ms": cuda_ms(fn, 5), "host_us": host_us(fn, 1),
            "device_events": win["events_per_step"] if win else None}
    g, s = out["greedy"]["traced_step"], out["sampled"]["traced_step"]
    return {"engine": out, "sampler_alone": alone,
            "events_added_per_step": (s["events_per_step"]
                                      - g["events_per_step"])
            if g and s else None,
            "device_ms_added_per_step": (s["device_busy_ms_per_step"]
                                         - g["device_busy_ms_per_step"])
            if g and s else None,
            "sampled_vs_greedy_step_ms":
                out["sampled"]["decode_step_ms_median"]
                / out["greedy"]["decode_step_ms_median"]}


def run_sampling(model, dev):
    """Phase (d-xiii) on the smoke's 32-layer model: steps 1-5 (see each).
    Returns the phase's launches of B1, B2, B3 and B4 (int8) for the
    kernels line."""
    t_phase = time.perf_counter()
    line = {"phase": "sampling", "card": card_line()}
    line["prng"] = prng_on_card(dev)
    line["distribution"] = sample_distribution(dev)
    torch.cuda.empty_cache()
    line["generate"], gen_launches = sampled_generate(model, dev)
    torch.cuda.empty_cache()
    line["serving"], serve_launches = sampled_serving(model, dev)
    torch.cuda.empty_cache()
    line["cost"] = sampler_cost(model, dev)
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    total = collections.Counter(serve_launches)
    total["b2_decode"] += gen_launches["b2_decode"]
    return {"b1": gen_launches["b1"], **total}


# ---------------------------------------------------------------------------
# (f) training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LAYERS = 4, 2048, 8, 4
# the reference bench line's defaults (bench.py:2762-2825): 7B widths with
# ff = hidden * 11 // 4, 3 layers, [6, 2048], recompute and bf16 moments
BENCH_B, BENCH_LAYERS, BENCH_FF = 6, 3, 11264
TRAIN_COUNTERS = {"flash_attention_fwd": flash_attention_fwd,
                  "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
                  "flash_attention_bwd_dq": flash_attention_bwd_dq,
                  "fused_adamw": fused_adamw_update,
                  "fused_adamw_sr": fused_adamw_sr_update}
SR_WARNING = "adamw_stochastic_rounding: shape not tileable"


def train_loss(m, ids, labels):
    loss, _ = m(ids, labels=labels)
    return loss


@contextlib.contextmanager
def training_flags(**flags):
    """The port's optimizer flags for one run, reset to False after it."""
    set_flags(flags)
    try:
        yield
    finally:
        set_flags({k: False for k in flags})


def train_model(dev, layers, **over):
    """A bf16 Llama at Llama-2-7B widths cut to ``layers`` layers, in
    training mode, seed 0."""
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16", num_hidden_layers=layers,
                                max_position_embeddings=TRAIN_S, **over)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.train()
    return model


def train_batch(vocab, B, dev):
    """Random ids and labels ``[B, 2048]`` as the reference's llama bench
    line makes them (``bench.py:2827-2831``)."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.integers(0, vocab, size=(B, TRAIN_S)))
                 .to(dev) for _ in range(2))


def drive(step, ids, labels, calls):
    """``calls`` TrainStep calls on one batch, every launch count set to 0
    just before. Per call: the loss (read back, so the call is waited
    for), the wall time, each kernel's launches, plain-chain AdamW updates,
    the stochastic-rounding chain warnings and the params without a grad.
    Returns the calls and the peak device memory in bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in TRAIN_COUNTERS.values():
        c.launches = 0
    calls_out = []
    for _ in range(calls):
        before = {n: c.launches for n, c in TRAIN_COUNTERS.items()}
        chain0 = Optimizer.chain_updates
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            loss = float(step(ids, labels))
            wall = time.perf_counter() - t0
        calls_out.append(dict(
            loss=loss, wall=wall,
            launches={n: c.launches - before[n]
                      for n, c in TRAIN_COUNTERS.items()},
            chain=Optimizer.chain_updates - chain0,
            sr_warnings=sum(SR_WARNING in str(w.message) for w in caught),
            missing=list(step.missing_grads)))
    return calls_out, torch.cuda.max_memory_allocated()


def traced_step(step, ids, labels):
    """One more TrainStep call under torch.profiler: its device time by
    kernel class and the device's idle share (information)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_breakdown(prof, wall, 1, TRAIN_CLASSES)


def train_report(name, model, calls, peak, B, expect, **extra):
    """Emit one training run's line and hold its gates: finite losses, the
    first within 0.5 of ln(vocab) (every run starts from fresh random
    weights), the last below the
    first, every parameter with a grad, and each call's launches, chain
    updates and warnings as ``expect(i)`` gives them. Timing: the median
    of the calls after the first two; MFU by the reference's convention
    (``flops_per_token``, forward and backward, recompute not counted)."""
    cfg = model.config
    losses = [c["loss"] for c in calls]
    walls = [c["wall"] * 1e3 for c in calls]
    step_ms = float(np.median(walls[2:]))
    tok_s = B * TRAIN_S / (step_ms / 1e3)
    flops_tok = model.flops_per_token(TRAIN_S)
    ln_vocab = float(np.log(cfg.vocab_size))
    got = [dict(c["launches"], chain_updates=c["chain"],
                sr_warnings=c["sr_warnings"]) for c in calls]
    want = [expect(i) for i in range(len(calls))]
    missing = sorted({n for c in calls for n in c["missing"]})
    line = {"phase": "train", "run": name, "layers": cfg.num_hidden_layers,
            "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
            "ff": cfg.intermediate_size, "vocab": cfg.vocab_size,
            "recompute": cfg.use_recompute,
            "fused_projections": cfg.fuse_attention_qkv,
            "params": sum(p.numel() for p in model.parameters()),
            "param_tensors": len(list(model.parameters())),
            "batch": [B, TRAIN_S], "calls": len(calls), "losses": losses,
            "ln_vocab": ln_vocab, "per_call": got, "expected_per_call": want,
            "params_without_grad": missing, "step_ms_each": walls,
            "step_ms_median_after_2": step_ms, "tokens_per_s": tok_s,
            "flops_per_token": flops_tok,
            "mfu": flops_tok * tok_s / PEAK_BF16_FLOPS,
            "peak_memory_gb": peak / 1e9, **extra}
    emit(line)
    require(all(np.isfinite(x) for x in losses), f"{name}: losses {losses}")
    require(abs(losses[0] - ln_vocab) <= 0.5,
            f"{name}: first loss {losses[0]} not within 0.5 of ln(vocab)")
    require(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    require(not missing, f"{name}: parameters without a grad: {missing}")
    require(got == want, f"{name}: per call {got} != {want}")
    return {n: sum(c["launches"][n] for c in calls) for n in TRAIN_COUNTERS}


def per_step(flash_fwd=0, dkv=0, dq=0, adamw=0, adamw_sr=0, chain=0,
             warn=0):
    return {"flash_attention_fwd": flash_fwd, "flash_attention_bwd_dkv": dkv,
            "flash_attention_bwd_dq": dq, "fused_adamw": adamw,
            "fused_adamw_sr": adamw_sr, "chain_updates": chain,
            "sr_warnings": warn}


def run_training(dev):
    """TrainStep at Llama-2-7B widths cut to 4 layers (float32 masters and
    moments: full depth would need 6.74 B params x 16 B ~ 108 GB) on one
    [4, 2048] batch, 8 steps, then one traced step. Returns the model, its
    optimizer and the kernel launches of the 8 steps."""
    model = train_model(dev, TRAIN_LAYERS)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.01, multi_precision=True,
                parameters=model.named_parameters())
    step = TrainStep(model, train_loss, opt)
    ids, labels = train_batch(model.config.vocab_size, TRAIN_B, dev)
    calls, peak = drive(step, ids, labels, TRAIN_STEPS)
    traced = traced_step(step, ids, labels)
    L, n = TRAIN_LAYERS, len(step.params)
    launches = train_report(
        "train", model, calls, peak, TRAIN_B,
        lambda i: per_step(L, L, L, adamw=n), traced_step=traced)
    return model, opt, launches


def run_train_accum(dev):
    """The same 4-layer run with ``accumulate_steps=2`` for 4 calls: the
    update (every parameter through the AdamW kernel's float32-grad form)
    only on the 2nd and 4th call."""
    model = train_model(dev, TRAIN_LAYERS)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.01, multi_precision=True,
                parameters=model.named_parameters())
    step = TrainStep(model, train_loss, opt, accumulate_steps=2)
    ids, labels = train_batch(model.config.vocab_size, TRAIN_B, dev)
    calls, peak = drive(step, ids, labels, 4)
    L, n = TRAIN_LAYERS, len(step.params)
    launches = train_report(
        "train_accum", model, calls, peak, TRAIN_B,
        lambda i: per_step(L, L, L, adamw=n * (i % 2)),
        optimizer_steps=opt._step_count)
    require(opt._step_count == 2, f"accumulation took {opt._step_count} "
            f"optimizer steps in 4 calls, not 2")
    return launches


RECOMPUTE_PASSES = (("off", False, None), ("full", True, None),
                    ("dots", True, "dots_saveable"),
                    ("dots_no_batch", True,
                     "dots_with_no_batch_dims_saveable"))


def run_train_recompute_exact(dev):
    """Two layers of the bench line's configuration, one [6, 2048] batch,
    forward and backward with recompute off, then on under the full
    policy and the two selective ``dots`` policies: every grad the same
    bits as without recompute (the replay runs the same kernels on the
    same inputs; the selective policies keep the matrix products and
    replay the flash forward, which launches through ctypes where no
    dispatch mode sees it, into a fresh buffer), and a lower peak under
    the full policy (counted above what was allocated before each
    pass)."""
    model = train_model(dev, 2, intermediate_size=BENCH_FF)
    ids, labels = train_batch(model.config.vocab_size, BENCH_B, dev)
    ref, losses, peaks, flash, diff = None, {}, {}, {}, {}
    launches = collections.Counter()
    for name, remat, policy in RECOMPUTE_PASSES:
        model.config.use_recompute = remat
        model.config.recompute_policy = policy
        for c in TRAIN_COUNTERS.values():
            c.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = train_loss(model, ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        losses[name] = float(loss.detach())
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
        flash[name] = flash_attention_fwd.launches
        launches.update({n: c.launches for n, c in TRAIN_COUNTERS.items()})
        grads = {n: p.grad for n, p in model.named_parameters()}
        if ref is None:
            ref = grads
        else:
            diff[name] = [n for n, g in ref.items()
                          if not torch.equal(g, grads[n])]
        for p in model.parameters():
            p.grad = None
        del grads
    line = {"phase": "train_recompute_exact", "layers": 2,
            "ff": BENCH_FF, "batch": [BENCH_B, TRAIN_S], "loss": losses,
            "peak_gb_above_base": peaks, "flash_fwd_launches": flash,
            "grads_compared": len(ref), "grads_not_bit_identical": diff}
    emit(line)
    require(not any(diff.values()), f"recompute changed grads: {diff}")
    require(len(set(losses.values())) == 1, f"losses {losses}")
    require(peaks["full"] < peaks["off"],
            f"recompute did not lower the peak: {peaks}")
    require(flash == {"off": 2, "full": 4, "dots": 4, "dots_no_batch": 4},
            f"flash forward launches {flash}")
    return dict(launches)


def run_train_bench_default(dev):
    """The reference bench line's defaults: 3 layers, ff 11264, [6, 2048],
    recompute, bf16 moments, AdamW(3e-4, weight_decay=0.01,
    multi_precision=True), 8 steps; every update takes the plain chain
    (bf16 moments beside float32 masters, as in the reference); flash
    forward 2L per step (forward and replay), dK/dV and dQ L. Then the same
    with fused q/k/v and gate/up projections for 4 steps."""
    launches = collections.Counter()
    for fused, steps in ((False, TRAIN_STEPS), (True, 4)):
        with training_flags(adamw_bf16_moments=True):
            model = train_model(dev, BENCH_LAYERS, intermediate_size=BENCH_FF,
                                use_recompute=True, fuse_attention_qkv=fused,
                                fuse_swiglu=fused)
            opt = AdamW(learning_rate=3e-4, weight_decay=0.01,
                        multi_precision=True,
                        parameters=model.named_parameters())
            step = TrainStep(model, train_loss, opt)
        ids, labels = train_batch(model.config.vocab_size, BENCH_B, dev)
        calls, peak = drive(step, ids, labels, steps)
        traced = None if fused else traced_step(step, ids, labels)
        L, n = BENCH_LAYERS, len(step.params)
        launches.update(train_report(
            "train_bench_default_fused" if fused else "train_bench_default",
            model, calls, peak, BENCH_B,
            lambda i: per_step(2 * L, L, L, chain=n), traced_step=traced))
        del model, opt, step
        torch.cuda.empty_cache()
    return dict(launches)


def run_train_sr_full_depth(dev):
    """``LlamaConfig.llama2_7b`` at all 32 layers, [4, 2048], recompute,
    master-free AdamW with stochastic rounding and bf16 moments
    (``BENCH_OPT=adamw_sr``), 8 steps: the stochastic-rounding kernel on
    every parameter the reference's kernel tiles (290), the chain with its
    warning on ``lm_head``. Returns the model, optimizer, TrainStep and the
    launches."""
    with training_flags(adamw_stochastic_rounding=True,
                        adamw_bf16_moments=True):
        model = train_model(dev, 32, use_recompute=True)
        opt = AdamW(learning_rate=3e-4, weight_decay=0.01,
                    multi_precision=False,
                    parameters=model.named_parameters())
        step = TrainStep(model, train_loss, opt)
        ids, labels = train_batch(model.config.vocab_size, TRAIN_B, dev)
        calls, peak = drive(step, ids, labels, TRAIN_STEPS)
        traced = traced_step(step, ids, labels)
    L, n = 32, len(step.params)
    tiled = sum(tile_plan(tuple(p.shape)) is not None for p in step.params)
    launches = train_report(
        "train_sr_full_depth", model, calls, peak, TRAIN_B,
        lambda i: per_step(2 * L, L, L, adamw_sr=tiled, chain=n - tiled,
                           warn=n - tiled),
        traced_step=traced, param_tensors_tiled=tiled,
        device_memory_gb=torch.cuda.get_device_properties(0).total_memory
        / 1e9)
    require((n, tiled) == (291, 290), f"{n} parameters, {tiled} tiled")
    return model, opt, step, launches


def time_adamw(model, opt, dev):
    """The AdamW kernel over every parameter of a step (one launch each,
    as TrainStep makes them) and on one [4096, 11008] tensor, against the
    plain version, with bf16 grads and with float32 ones (an accumulated
    mean); bytes bound: 28 B per parameter, 30 B with a float32 grad."""
    params = [p for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(14)
    slots = [opt._slots[id(p)] for p in params]
    out = {}
    for gname, gdt, nbytes in (("bf16_grad", torch.bfloat16, 28),
                               ("f32_grad", torch.float32, 30)):
        grads = [(torch.randn(p.shape, device=dev, generator=gen) * 1e-3)
                 .to(gdt) for p in params]

        def run(fn):
            def go():
                for p, g, s in zip(params, grads, slots):
                    fn(p, g, s["moment1"], s["moment2"], s["master_weight"],
                       3e-4, 9, weight_decay=0.01)
            return go
        ms = cuda_ms(run(fused_adamw_update), 5)
        plain_ms = cuda_ms(run(fused_adamw_update_plain), 2)
        one = next(i for i, p in enumerate(params)
                   if tuple(p.shape) == ADAMW_SHAPE)
        p1, g1, s1 = params[one], grads[one], slots[one]
        one_args = (p1, g1, s1["moment1"], s1["moment2"], s1["master_weight"],
                    3e-4, 9)
        one_ms = cuda_ms(lambda: fused_adamw_update(*one_args), 20)
        one_plain = cuda_ms(lambda: fused_adamw_update_plain(*one_args), 5)
        n = sum(p.numel() for p in params)
        out[gname] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=nbytes * n / PEAK_BYTES * 1e3, bound_by="bytes",
            params=n, launches_per_step=len(params),
            one_tensor=dict(shape=list(ADAMW_SHAPE), ms=one_ms,
                            plain_ms=one_plain,
                            bound_ms=nbytes * p1.numel() / PEAK_BYTES * 1e3))
        del grads
        torch.cuda.empty_cache()
    return dict(out["bf16_grad"], f32_grad=out["f32_grad"])


def time_adamw_sr(step, dev):
    """The stochastic-rounding kernel over the parameters a full-depth
    step sends it (290 launches) and on one [4096, 11008] tensor, against
    the plain version, with a bf16 grad (and, for the one tensor, a
    float32 grad); one random grad per distinct shape. Bytes bound: 14 B
    per parameter (read g, p, m, v; write p, m, v), 16 B with a float32
    grad. No PyTorch call rounds stochastically, so no library time."""
    opt = step.optimizer
    gen = torch.Generator(device=dev).manual_seed(15)
    work = [(i, p, opt._slots[id(p)]) for i, p in enumerate(step.params)
            if tile_plan(tuple(p.shape)) is not None]
    grads = {}
    for _, p, _ in work:
        if tuple(p.shape) not in grads:
            grads[tuple(p.shape)] = (torch.randn(p.shape, device=dev,
                                                 generator=gen) * 1e-3) \
                .to(torch.bfloat16)

    def run(fn):
        def go():
            for i, p, s in work:
                fn(p, grads[tuple(p.shape)], s["moment1"], s["moment2"],
                   3e-4, 9, sr_seed(9, i), weight_decay=0.01)
        return go
    ms = cuda_ms(run(fused_adamw_sr_update), 3)
    plain_ms = cuda_ms(run(fused_adamw_sr_update_plain), 1)
    i1, p1, s1 = next(w for w in work if tuple(w[1].shape) == ADAMW_SHAPE)
    one = {}
    for gname, gdt, nbytes in (("bf16_grad", torch.bfloat16, 14),
                               ("f32_grad", torch.float32, 16)):
        g1 = grads[ADAMW_SHAPE].to(gdt)
        args = (p1, g1, s1["moment1"], s1["moment2"], 3e-4, 9, sr_seed(9, i1))
        one[gname] = dict(
            ms=cuda_ms(lambda: fused_adamw_sr_update(*args), 20),
            plain_ms=cuda_ms(lambda: fused_adamw_sr_update_plain(*args), 5),
            bound_ms=nbytes * p1.numel() / PEAK_BYTES * 1e3)
    n = sum(p.numel() for _, p, _ in work)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=14 * n / PEAK_BYTES * 1e3, bound_by="bytes",
                params=n, launches_per_step=len(work),
                one_tensor=dict(shape=list(ADAMW_SHAPE), **one))


def time_flash_bwd(dev):
    """The dK/dV and dQ kernels at the training shape [4, 2048, 32, 128]
    causal, their plain versions, the whole backward (delta, then both
    kernels) and PyTorch's flash-attention backward on the same inputs
    (the autograd backward of F.scaled_dot_product_attention under the
    flash backend). Bounds count what the function needs: the dK/dV
    function four products (S, dP, dV, dK), the dQ function three, the
    whole backward five; each input read once, each output written once."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, S, H, D = TRAIN_B, TRAIN_S, 32, 128
    rng = np.random.default_rng(13)
    q, k, v = flash_case(rng, dev, B, S, H, H, D)
    do = randn(rng, (B, S, H, D), dev)
    out, lse = flash_attention_fwd(q, k, v, True)
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta, True)
    dkv_ms = cuda_ms(lambda: flash_attention_bwd_dkv(*args), 10)
    dq_ms = cuda_ms(lambda: flash_attention_bwd_dq(*args), 10)
    dkv_us = host_us(lambda: flash_attention_bwd_dkv(*args))
    dq_us = host_us(lambda: flash_attention_bwd_dq(*args))
    total_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                   True), 10)
    dkv_plain = cuda_ms(lambda: flash_attention_bwd_dkv_plain(*args), 2)
    torch.cuda.empty_cache()
    dq_plain = cuda_ms(lambda: flash_attention_bwd_dq_plain(*args), 2)
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 10)
    product = 2 * D * (B * H * S * (S + 1) // 2)   # one product, causal
    elem = 2 * B * S * H * D                       # one bf16 [B, S, H, D]
    stat = 4 * B * H * S                           # lse or delta

    def bound(products, nbytes):
        t_ops = products * product / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    ops=products * product, bytes=nbytes)
    return {"shape": [B, S, H, D], "causal": True,
            "flash_attention_bwd_dkv": dict(
                ms=dkv_ms, plain_ms=dkv_plain, library_ms=None,
                host_us_per_call=dkv_us, **bound(4, 6 * elem + 2 * stat)),
            "flash_attention_bwd_dq": dict(
                ms=dq_ms, plain_ms=dq_plain, library_ms=None,
                host_us_per_call=dq_us, **bound(3, 5 * elem + 2 * stat)),
            "whole_backward": dict(ms=total_ms, library_ms=lib_ms,
                                   **bound(5, 8 * elem + stat))}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    require(not torch.backends.cuda.matmul.allow_tf32,
            "float32 matmuls must run in full precision")
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})
    # B1's, B5's, the paged libraries' and B8's own lines: each
    # instantiation's registers, shared memory, spills, and any wgmma the
    # compiler serialised (C75xx notes); B5 may neither spill nor have a
    # warpgroup.arrive injected, B2, B3 and B4 (the int8/int4
    # instantiations of the decode and append sources) and B8 may not
    # spill
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "paged_attention_decode", "paged_attention_append",
                 "int4_matmul"):
        emit({"phase": "ptxas", "kernel": name,
              "lines": [ln.strip() for ln in logs[name].splitlines()
                        if "ptxas" in ln or "spill" in ln]})
    for name in ("paged_attention_decode", "paged_attention_append",
                 "int4_matmul"):
        require(all("0 bytes spill stores, 0 bytes spill loads" in ln
                    for ln in logs[name].splitlines() if "spill" in ln),
                f"{name}: ptxas reports a spill")
    bwd_log = logs["flash_attention_bwd"]
    require("C7519" not in bwd_log and all(
        "0 bytes spill stores, 0 bytes spill loads" in ln
        for ln in bwd_log.splitlines() if "spill" in ln),
        "flash_attention_bwd: ptxas reports a spill or an injected "
        "warpgroup.arrive")

    flash_err = check_flash(dev)
    paged_err = check_paged(dev)
    append_err = check_append(dev)
    paged_q_err = check_paged_quant(dev)
    append_q_err = check_append_quant(dev)
    bwd_err = check_flash_bwd(dev)
    adamw_err = check_adamw(dev)
    adamw_sr_err = check_adamw_sr(dev)
    int4_err = check_int4_matmul(dev)
    torch.cuda.empty_cache()

    model = build_model(dev)
    flash_launches = run_forward(model, dev)
    torch.cuda.empty_cache()
    paged_launches, legacy_tokens = run_serving(model, dev)
    torch.cuda.empty_cache()
    append_launches, fused_decode_launches, fused_tokens = \
        run_fused_serving(model, dev, legacy_tokens)
    torch.cuda.empty_cache()
    quant_launches = run_quant_serving(model, dev)
    torch.cuda.empty_cache()
    gen_launches = run_generate(model, dev)
    torch.cuda.empty_cache()
    prefix_launches = run_prefix_cache(model, dev)
    torch.cuda.empty_cache()
    dense_launches = run_dense_serving(model, dev, fused_tokens)
    torch.cuda.empty_cache()
    rung_launches = run_serve_rung(model, dev)
    torch.cuda.empty_cache()
    rung = spec_rung_model(dev)
    spec_launches = run_spec_rung(rung, dev)
    torch.cuda.empty_cache()
    legacy_spec_b8 = run_legacy_spec(rung, dev,
                                     spec_launches["b8_on_tokens_per_s"])
    del rung
    gc.collect()
    torch.cuda.empty_cache()
    tier_launches = run_kv_tier(dev)
    torch.cuda.empty_cache()
    cluster_launches = run_cluster(dev)
    torch.cuda.empty_cache()
    disagg_launches = run_disagg(dev)
    torch.cuda.empty_cache()
    sampling_launches = run_sampling(model, dev)
    torch.cuda.empty_cache()

    ft, pt, at = time_flash(dev), time_paged(dev), time_append(dev)
    qt = {q: (time_paged_quant(dev, q), time_append_quant(dev, q))
          for q in QUANTS}
    emit({"phase": "timing", "flash_attention_fwd": ft,
          "paged_attention_decode": pt, "paged_attention_append": at,
          **{f"paged_attention_decode_{q}": qt[q][0] for q in QUANTS},
          **{f"paged_attention_append_{q}": qt[q][1] for q in QUANTS}})
    torch.cuda.empty_cache()
    emit({"phase": "decode_profile", "breakdown": profile_decode(model, dev)})
    torch.cuda.empty_cache()
    emit({"phase": "fused_profile", "windows": profile_fused(model, dev)})
    del model
    torch.cuda.empty_cache()
    model = build_model(dev, intermediate_size=WO_FF)
    int4_launches, int4_margin = run_weight_only_serving(model, dev)
    gen_int4_launches = run_generate_int4(model, dev, int4_margin)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    i4t = time_int4_matmul(dev)
    emit({"phase": "timing", "int4_matmul": i4t,
          "int4_matmul_rows48": time_int4_matmul(dev, rows=48),
          "int4_matmul_rows128": time_int4_matmul(dev, rows=128)})
    torch.cuda.empty_cache()

    train_launches = collections.Counter()
    model, opt, launches = run_training(dev)
    train_launches.update(launches)
    torch.cuda.empty_cache()
    wt = time_adamw(model, opt, dev)
    del model, opt
    torch.cuda.empty_cache()
    bt = time_flash_bwd(dev)
    emit({"phase": "timing", "fused_adamw": wt, "flash_attention_bwd": bt})
    torch.cuda.empty_cache()
    for run in (run_train_accum, run_train_recompute_exact,
                run_train_bench_default):
        train_launches.update(run(dev))
        torch.cuda.empty_cache()
    model, opt, step, launches = run_train_sr_full_depth(dev)
    train_launches.update(launches)
    srt = time_adamw_sr(step, dev)
    emit({"phase": "timing", "fused_adamw_sr": srt})
    del model, opt, step
    torch.cuda.empty_cache()
    dkv, dq = bt["flash_attention_bwd_dkv"], bt["flash_attention_bwd_dq"]
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": FLASH_SRC,
         "replaces": FLASH_REPLACES,
         "launches": flash_launches + train_launches["flash_attention_fwd"]
         + gen_launches["b1"] + gen_int4_launches["b1"]
         + sampling_launches["b1"],
         "max_abs_err": flash_err, "ms": ft["ms"], "plain_ms": ft["plain_ms"],
         "bound_ms": ft["bound_ms"], "bound_by": ft["bound_by"],
         "library_ms": ft["library_ms"]},
        {"name": "paged_attention_decode", "route": "cuda",
         "source": PAGED_SRC, "replaces": PAGED_REPLACES,
         "launches": paged_launches + fused_decode_launches
         + gen_launches["b2"] + prefix_launches.get("b2_decode", 0)
         + dense_launches["b2_decode"] + rung_launches["b2_decode"]
         + spec_launches["b2_decode"] + tier_launches["b2_decode"]
         + cluster_launches["b2_decode"] + disagg_launches["b2_decode"]
         + sampling_launches["b2_decode"],
         "max_abs_err": paged_err, "ms": pt["ms"],
         "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
         "bound_by": pt["bound_by"], "library_ms": pt["library_ms"]},
        {"name": "paged_attention_append", "route": "cuda",
         "source": APPEND_SRC, "replaces": APPEND_REPLACES,
         "launches": append_launches + prefix_launches.get("b3_append", 0)
         + dense_launches["b3_append"] + rung_launches["b3_append"]
         + spec_launches["b3_append"] + tier_launches["b3_append"]
         + cluster_launches["b3_append"] + disagg_launches["b3_append"]
         + sampling_launches["b3_append"],
         "max_abs_err": append_err,
         "ms": at["ms"], "plain_ms": at["plain_ms"],
         "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
         "library_ms": at["library_ms"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": BWD_SRC, "replaces": DKV_REPLACES,
         "launches": train_launches["flash_attention_bwd_dkv"],
         "max_abs_err": bwd_err["flash_attention_bwd_dkv"], "ms": dkv["ms"],
         "plain_ms": dkv["plain_ms"], "bound_ms": dkv["bound_ms"],
         "bound_by": dkv["bound_by"], "library_ms": dkv["library_ms"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": BWD_SRC, "replaces": DQ_REPLACES,
         "launches": train_launches["flash_attention_bwd_dq"],
         "max_abs_err": bwd_err["flash_attention_bwd_dq"], "ms": dq["ms"],
         "plain_ms": dq["plain_ms"], "bound_ms": dq["bound_ms"],
         "bound_by": dq["bound_by"], "library_ms": dq["library_ms"]},
        {"name": "fused_adamw", "route": "cuda", "source": ADAMW_SRC,
         "replaces": ADAMW_REPLACES,
         "launches": train_launches["fused_adamw"],
         "max_abs_err": adamw_err, "ms": wt["ms"],
         "plain_ms": wt["plain_ms"], "bound_ms": wt["bound_ms"],
         "bound_by": wt["bound_by"], "library_ms": wt["library_ms"]},
        {"name": "fused_adamw_sr", "route": "cuda", "source": ADAMW_SR_SRC,
         "replaces": ADAMW_SR_REPLACES,
         "launches": train_launches["fused_adamw_sr"],
         "max_abs_err": adamw_sr_err, "ms": srt["ms"],
         "plain_ms": srt["plain_ms"], "bound_ms": srt["bound_ms"],
         "bound_by": srt["bound_by"], "library_ms": srt["library_ms"]},
    ]
    for q in QUANTS:
        for form, src, replaces, err, t, n in (
                ("decode", PAGED_SRC, PAGED_REPLACES, paged_q_err[q],
                 qt[q][0], quant_launches[q][0]),
                ("append", APPEND_SRC, APPEND_REPLACES, append_q_err[q],
                 qt[q][1], quant_launches[q][1])):
            kernels.append(
                {"name": f"paged_attention_{form}_{q}", "route": "cuda",
                 "source": src, "replaces": replaces,
                 "launches": n + prefix_launches.get(f"b4_{form}_{q}", 0)
                 + tier_launches.get(f"b4_{form}_{q}", 0)
                 + disagg_launches.get(f"b4_{form}_{q}", 0)
                 + sampling_launches.get(f"b4_{form}_{q}", 0),
                 "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"]})
    lt = i4t["layer"]
    kernels.append(
        {"name": "int4_matmul", "route": "cuda", "source": INT4_SRC,
         "replaces": INT4_REPLACES,
         "launches": int4_launches + gen_int4_launches["b8"]
         + legacy_spec_b8,
         "max_abs_err": int4_err, "ms": lt["ms"], "plain_ms": lt["plain_ms"],
         "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
         "library_ms": lt["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile-quant"] and len(sys.argv) == 3:
        sys.exit(profile_quant_main(sys.argv[2]))
    sys.exit(main())
