"""Bytes-on-wire KV shipping (counterpart:
``paddle_tpu/serving/kv_transport.py``).

The disaggregated prefill/decode split moves a finished prefill's
committed KV from a prefill replica to a decode replica instead of
recomputing it. The engine side of that move is the host KV tier's
staging machinery: ``LLMEngine._export_slot_kv`` gathers with the same
``_stage_blocks`` the swap tier uses, and ``LLMEngine.import_kv`` seeds the
same swap store the restore path drains. This module owns the transport:
turning a staged entry into bytes and back, and the interface a
multi-host transport would implement.

Wire format, PTKV version 1, byte for byte the reference's:

``PTKV`` magic, a little-endian u32 header length, a JSON header
(``sort_keys=True``; identity, geometry, a per-leaf dtype/shape table and
the reference's pool structure strings), the request's int32 token bytes,
then each leaf's raw bytes in table order. The reference's pool is a list
of L arrays ``[n, Hkv, bs, D]`` per side, or L ``(int8 payload
[n, Hkv, bs, Dp], float32 scale [n, Hkv])`` pairs on a quantized pool; its
header names that structure as jax prints it (``PyTreeDef([*, *])`` or
``PyTreeDef([(*, *), (*, *)])``) with leaf paths ``0``, ``1``, ... or
``0/0``, ``0/1``, .... A staged entry of this port is laid out blocks
first, ``{"kv": [n, 2L, Hkv, bs, Dp], "scale": [n, 2L, Hkv] | None}`` (K
layers, then V), so the transport translates between the two layouts and
writes the structure strings from L and the quantization, never from jax.
Leaf dtypes ride by NAME (``bfloat16``, ``float32``, ``int8``); bf16
leaves travel as their raw 2-byte words (no ``ml_dtypes`` needed), and an
int4 pool's leaves are its int8 payload at the packed ``Dp``, as on both
sides.

Transports implement :class:`KVTransport.ship`; the in-process
:class:`InProcessTransport` (loopback through real serialized bytes) is
the only one here.
"""
import json
import struct
import time

import numpy as np
import torch

__all__ = ["KVTransport", "InProcessTransport", "serialize_entry",
           "deserialize_entry", "TransportError", "MIGRATION_PHASES",
           "pool_treedefs"]

_MAGIC = b"PTKV"
_VERSION = 1

#: the phases a prefill->decode migration decomposes into, in causal
#: order (reference ``kv_transport.py:44-53``). The first three are timed
#: inside :meth:`KVTransport.ship` (returned per call); "place" is the
#: router's decode-side resubmission, "stitch" the destination engine's
#: restore of the shipped entry. The router books one histogram per
#: phase and ``explain_tail`` attributes migration gaps as
#: ``kv_ship:{phase}``.
MIGRATION_PHASES = ("serialize", "transport", "import", "place",
                    "stitch")

#: wire dtype name -> (torch dtype, numpy dtype of its raw words)
_DTYPES = {"bfloat16": (torch.bfloat16, np.dtype(np.int16)),
           "float16": (torch.float16, np.dtype(np.float16)),
           "float32": (torch.float32, np.dtype(np.float32)),
           "int8": (torch.int8, np.dtype(np.int8))}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


class TransportError(RuntimeError):
    """A ship failed in the transport itself (encode/decode/send). The
    router treats it like any other ship failure: fall back to re-prefill
    on the destination."""


def _treedef(n_layers, quant):
    """One side's pool structure as the reference's header prints it: a
    list of ``n_layers`` arrays, or of (payload, scale) pairs."""
    leaf = "(*, *)" if quant else "*"
    return "PyTreeDef([" + ", ".join([leaf] * n_layers) + "])"


def _paths(n_layers, quant):
    if quant:
        return [f"{i}/{j}" for i in range(n_layers) for j in (0, 1)]
    return [str(i) for i in range(n_layers)]


def pool_treedefs(engine):
    """``engine``'s (k_def, v_def) structure strings: what a shipped entry's
    header must name for this engine's pools to take it."""
    s = _treedef(engine._n_layers, bool(engine.kv_quant))
    return s, s


def _raw(t):
    """A CPU tensor's elements as numpy raw words (bf16 as int16), a view
    where the tensor allows."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _leaves(entry):
    """The entry's leaves in the reference's table order: every layer's K
    (payload, then its scale rows on a quantized pool), then V."""
    kv, sc = entry["kv"], entry.get("scale")
    two_l = kv.shape[1]
    out = []
    for j in range(two_l):
        out.append(kv[:, j])
        if sc is not None:
            out.append(sc[:, j])
    return out, two_l // 2


def serialize_entry(entry):
    """Encode a staged entry (``LLMEngine.export_kv``'s return value, or
    one element of ``export_prefix_blocks``) to PTKV bytes, equal to the
    reference's ``serialize_entry`` of the same entry in its layout."""
    if not entry.get("ready"):
        raise TransportError("entry not materialized (ready=False); "
                             "export_kv() materializes before handoff")
    leaves, n_layers = _leaves(entry)
    quant = entry.get("scale") is not None
    n_k = len(leaves) // 2
    tokens = entry["tokens"]
    tok_b = tokens if isinstance(tokens, bytes) \
        else np.asarray(tokens, np.int32).tobytes()
    h, parent = entry.get("hash"), entry.get("parent")
    header = {
        "v": _VERSION,
        "rid": entry.get("rid"),
        # chain hashes are raw blake2b digests: hex for the JSON header
        "hash": h.hex() if h is not None else None,
        "parent": parent.hex() if parent is not None else None,
        "adapter_id": int(entry.get("adapter_id", 0)),
        "n_blocks": int(entry["n_blocks"]),
        "block_size": int(entry["block_size"]),
        "kv_quant": entry.get("kv_quant"),
        "chain": [c.hex() for c in (entry.get("chain") or ())],
        "nbytes": int(entry["nbytes"]),
        "n_k": n_k,
        "k_def": _treedef(n_layers, quant),
        "v_def": _treedef(n_layers, quant),
        "k_paths": _paths(n_layers, quant),
        "v_paths": _paths(n_layers, quant),
        "leaves": [{"dtype": _NAMES[a.dtype], "shape": list(a.shape)}
                   for a in leaves],
        "tok_len": len(tok_b),
    }
    hb = json.dumps(header, sort_keys=True).encode()
    head = _MAGIC + struct.pack("<I", len(hb)) + hb + tok_b
    sizes = [a.numel() * a.element_size() for a in leaves]
    buf = bytearray(len(head) + sum(sizes))
    buf[:len(head)] = head
    off = len(head)
    # one copy a leaf, straight from the strided slice of the host copy
    for a, n in zip(leaves, sizes):
        src = _raw(a)
        dst = np.frombuffer(buf, src.dtype, src.size, off)
        np.copyto(dst.reshape(src.shape), src)
        off += n
    return bytes(buf)


def _read_header(data):
    if bytes(data[:4]) != _MAGIC:
        raise TransportError("bad magic: not a PTKV payload")
    (hlen,) = struct.unpack("<I", bytes(data[4:8]))
    try:
        header = json.loads(bytes(data[8:8 + hlen]).decode())
    except ValueError as e:
        raise TransportError(f"corrupt header: {e}")
    if header.get("v") != _VERSION:
        raise TransportError(f"wire version {header.get('v')} != "
                             f"{_VERSION}")
    return header, 8 + hlen


def deserialize_entry(data, treedefs=None, pin_memory=False):
    """Decode PTKV bytes (the port's or the reference's) into a staged
    entry of this port's layout (``kv``/``scale`` host tensors).

    ``treedefs=(k_def, v_def)``: the destination pools' structure strings
    (:func:`pool_treedefs`); the header's must equal them, else the two
    replicas run different pool layouts and :class:`TransportError`
    raises, as it does for a structure that is no pool's (each side a
    list of layers, or of (payload, scale) pairs). ``pin_memory``: land
    the blocks in pinned host memory, so a restore on the card copies
    them up without blocking the host."""
    header, off = _read_header(data)
    tok_b = bytes(data[off:off + header["tok_len"]])
    off += header["tok_len"]
    metas = header["leaves"]
    sizes = []
    for meta in metas:
        if meta["dtype"] not in _DTYPES:
            raise TransportError(f"unknown leaf dtype {meta['dtype']!r}")
        sizes.append(int(np.prod(meta["shape"], dtype=np.int64))
                     * _DTYPES[meta["dtype"]][1].itemsize)
    if off + sum(sizes) != len(data):
        raise TransportError("trailing bytes: payload/table mismatch")
    if treedefs is not None:
        k_def, v_def = treedefs
        if str(k_def) != header["k_def"] or str(v_def) != header["v_def"]:
            raise TransportError("pool pytree structure mismatch "
                                 "between replicas")
    n_k = header["n_k"]
    per = 2 if header["k_def"].startswith("PyTreeDef([(") else 1
    n_layers = n_k // per
    if len(metas) != 2 * n_k or not n_layers or header["k_def"] != \
            header["v_def"] or header["k_def"] != _treedef(n_layers,
                                                           per == 2):
        raise TransportError(f"pool pytree structure {header['k_def']!r} "
                             f"is no pool's (L layers, or L pairs)")
    entry = {"rid": header["rid"], "adapter_id": header["adapter_id"],
             "tokens": np.frombuffer(tok_b, np.int32).copy(),
             "n_blocks": header["n_blocks"],
             "block_size": header["block_size"],
             "kv_quant": header["kv_quant"],
             "chain": [bytes.fromhex(c) for c in header["chain"]],
             "ready": True, "nbytes": header["nbytes"]}
    if header.get("hash") is not None:
        entry["hash"] = bytes.fromhex(header["hash"])
        entry["parent"] = bytes.fromhex(header["parent"])
        entry["tokens"] = tok_b      # prefix-block entries keep bytes

    kmeta = metas[0]
    kv = torch.empty((kmeta["shape"][0], 2 * n_layers,
                      *kmeta["shape"][1:]),
                     dtype=_DTYPES[kmeta["dtype"]][0], pin_memory=pin_memory)
    sc = None
    if per == 2:
        smeta = metas[1]
        sc = torch.empty((smeta["shape"][0], 2 * n_layers,
                          *smeta["shape"][1:]),
                         dtype=_DTYPES[smeta["dtype"]][0],
                         pin_memory=pin_memory)
    kv_np, sc_np = _raw(kv), (_raw(sc) if sc is not None else None)
    o = off
    for i, meta in enumerate(metas):
        j, which = divmod(i, per)
        dst = (kv_np if which == 0 else sc_np)[:, j]
        raw = _DTYPES[meta["dtype"]][1]
        src = np.frombuffer(data, raw, sizes[i] // raw.itemsize,
                            o).reshape(meta["shape"])
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise TransportError(
                f"leaf {i} is {meta['dtype']} {list(src.shape)}, unlike "
                f"its side's first leaf")
        np.copyto(dst, src)
        o += sizes[i]
    entry["kv"], entry["scale"] = kv, sc
    return entry


class KVTransport:
    """Bytes-on-wire transport interface for staged KV entries.

    ``ship(entry, dst_engine)`` moves ONE staged entry to the destination
    engine and returns ``(wire_bytes, phases)``, ``phases`` mapping the
    transport-side :data:`MIGRATION_PHASES` names (serialize, transport,
    import) to seconds for THIS ship: returned per call, never stashed on
    the transport, so concurrent ships cannot clobber each other's
    timings. Raise :class:`TransportError` and the router falls back to
    re-prefill: shipping is an optimization, never a correctness
    dependency."""

    def ship(self, entry, dst_engine):
        raise NotImplementedError

    def ship_prefix_blocks(self, entries, dst_engine):
        """Move pull-on-miss prefix-block entries; returns
        (queued_count, wire_bytes)."""
        raise NotImplementedError


def _pin_for(engine):
    return getattr(getattr(engine, "device", None), "type", None) == "cuda"


class InProcessTransport(KVTransport):
    """Loopback transport: serialize -> bytes -> deserialize -> import.

    Runs the real wire encode and decode (not an object handoff), so every
    ship round-trips its bytes, quantized (payload, scale) pairs included.
    Keeps the counters ``ship_count``, ``ship_bytes`` and ``fail_count``
    the router folds into its snapshot, and times each ship's serialize,
    transport (here the decode-side deserialization) and import phases.
    On a card destination the blocks land in pinned host memory."""

    def __init__(self):
        self.ship_count = 0
        self.ship_bytes = 0
        self.fail_count = 0

    def ship(self, entry, dst_engine):
        phases = {}
        try:
            t0 = time.perf_counter()
            wire = serialize_entry(entry)
            t1 = time.perf_counter()
            phases["serialize"] = t1 - t0
            staged = deserialize_entry(wire, pool_treedefs(dst_engine),
                                       pin_memory=_pin_for(dst_engine))
            t2 = time.perf_counter()
            phases["transport"] = t2 - t1
            ok = dst_engine.import_kv(staged)
            phases["import"] = time.perf_counter() - t2
        except (TransportError, KeyError, ValueError) as e:
            self.fail_count += 1
            raise TransportError(str(e))
        if not ok:
            self.fail_count += 1
            raise TransportError("destination rejected entry "
                                 "(pool geometry/validation)")
        self.ship_count += 1
        self.ship_bytes += len(wire)
        return len(wire), phases

    def ship_prefix_blocks(self, entries, dst_engine):
        total = 0
        staged = []
        for e in entries:
            wire = serialize_entry(e)
            staged.append(deserialize_entry(
                wire, pool_treedefs(dst_engine),
                pin_memory=_pin_for(dst_engine)))
            total += len(wire)
        n = dst_engine.import_prefix_blocks(staged)
        if n:
            self.ship_count += n
            self.ship_bytes += total
        return n, total
