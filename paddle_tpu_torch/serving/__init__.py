"""paddle_tpu_torch.serving — the async server over the LLM engine
(counterpart: ``paddle_tpu/serving``).

:class:`AsyncLLMServer` runs one engine's pipelined continuous-batching
loop on a background thread, behind a bounded admission queue with
backpressure, per-request streaming, cancellation and deadlines, and
per-stage telemetry (:mod:`paddle_tpu_torch.profiler.serving_telemetry`),
and optionally a flight recorder and a metrics store
(:mod:`paddle_tpu_torch.profiler`). :class:`RestartPolicy` arms supervised
crash recovery and :class:`FaultInjector` scripts chaos for the tests.
:class:`ReplicaRouter` (``cluster.py``) places requests over several
servers by prefix affinity and load, with failover, drain, disaggregated
prefill/decode roles and prefix pulls; ``kv_transport.py`` carries the
shipped KV as PTKV bytes (:class:`InProcessTransport`).

Not in this port yet: the tensor-parallel engine (A14), adapters and
embeddings (A10) and the SLO, pathology-detector and black-box layer
(A11).
"""
from .types import (RequestHandle, RequestState, ServeRequest, ServeResult,
                    ServerClosed, ServerQueueFull, TraceContext)
from .scheduler import AdmissionQueue
from .faults import FaultInjector, InjectedFault, RestartPolicy
from .server import AsyncLLMServer
from .cluster import ReplicaRouter, RouterHandle
from .kv_transport import (InProcessTransport, KVTransport, TransportError,
                           deserialize_entry, serialize_entry)

__all__ = ["AsyncLLMServer", "AdmissionQueue", "RequestHandle",
           "RequestState", "ServeRequest", "ServeResult", "ServerClosed",
           "ServerQueueFull", "TraceContext", "FaultInjector",
           "InjectedFault", "RestartPolicy", "ReplicaRouter",
           "RouterHandle", "KVTransport", "InProcessTransport",
           "TransportError", "serialize_entry", "deserialize_entry"]
