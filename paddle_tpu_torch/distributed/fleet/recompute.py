"""Activation recomputation (counterpart:
``paddle_tpu/distributed/fleet/recompute.py`` :29-153).

The reference runs a segment through ``jax.checkpoint`` under a policy;
the port runs it through ``torch.utils.checkpoint(use_reentrant=False)``:
the forward keeps none of the segment's intermediates, and the backward
replays the segment to rebuild them. The flash kernels are not dots in
either package (the reference's are Pallas calls, the port's launch
through ctypes, which no dispatch mode sees), so every policy replays
them; their outputs are allocated afresh by each replay.

Policies, by the reference's names:

- ``None``, ``"full"``, ``"nothing_saveable"``: save nothing but the
  segment's inputs;
- ``"dots_saveable"``: also keep the outputs of ``aten.mm``, ``addmm``,
  ``bmm`` and ``baddbmm`` (selective checkpointing);
- ``"dots_with_no_batch_dims_saveable"``: keep only ``mm`` and ``addmm``
  outputs: a ``[B, S, H] @ [H, O]`` projection is a dot with no batch
  dimension in JAX and folds to ``mm`` in torch;
- ``"everything_saveable"``: keep everything, which is running the
  segment plainly.

Randomness: the segment runs inside
:func:`paddle_tpu_torch.core.random.provide_seed` with a seed drawn once
before it, so the replay draws the same dropout seeds (the reference
draws one key before the segment, :84-86).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...core.random import draw_seed, provide_seed

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default)
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)

#: policy name -> the ops whose outputs the forward keeps (None: none,
#: "all": every intermediate)
POLICIES = {
    None: None,
    "full": None,
    "nothing_saveable": None,
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "everything_saveable": "all",
}


def _keep_ops(saved_ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved_ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _seeded(function, seed):
    def run(*args, **kwargs):
        with provide_seed(seed):
            return function(*args, **kwargs)
    return run


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only what
    ``checkpoint_policy`` saves; the backward replays the rest.

    Keyword-only extras, as the reference accepts them (all others go to
    ``function``): ``use_reentrant`` (ignored: one semantics here),
    ``preserve_rng_state`` (default True: torch's own generators are
    restored for the replay; the port's dropout seeds repeat either way)
    and ``checkpoint_policy``, a name in :data:`POLICIES`."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    saved = POLICIES[kwargs.pop("checkpoint_policy", None)]
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    run = _seeded(function, draw_seed())
    if saved == "all":
        return run(*args, **kwargs)
    extra = {}
    if saved is not None:
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_keep_ops, saved))
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **extra, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute ``functions`` (a list or ``ModuleList``) in
    ``ctx["segments"]`` chunks, each one unit (reference :112-143)."""
    segments = int(ctx.get("segments", 1)) if isinstance(ctx, dict) \
        else int(ctx)
    policy = ctx.get("checkpoint_policy") if isinstance(ctx, dict) else None
    fns = list(functions)
    if not fns:
        raise ValueError("recompute_sequential needs at least one function")
    segments = max(1, min(segments, len(fns)))
    per = (len(fns) + segments - 1) // segments

    def run_chunk(chunk, *xs, **kw):
        out = xs
        for f in chunk:
            out = f(*out, **kw) if isinstance(out, tuple) else f(out, **kw)
            if not isinstance(out, tuple):
                out = (out,)
        return out[0] if len(out) == 1 else out

    out = args
    for s in range(0, len(fns), per):
        if not isinstance(out, tuple):
            out = (out,)
        out = recompute(functools.partial(run_chunk, tuple(fns[s:s + per])),
                        *out, checkpoint_policy=policy, **kwargs)
    return out
