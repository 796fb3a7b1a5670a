"""paddle_tpu_torch.inference.frontend — the serving front door.

Turns N single-caller :class:`~paddle_tpu_torch.inference.serving.LLMEngine`
replicas into one service:

- :mod:`.replica` — per-replica step-loop threads behind a thread-safe
  submit/stream/cancel facade (:class:`ReplicaSet`), with replica death as a
  first-class typed event.
- :mod:`.router` — prefix-cache-aware routing on the engine's own chain-hash
  page keys (:class:`PrefixAffinityRouter`), round-robin baseline.
- :mod:`.admission` — SLO-aware shedding before a request reaches a replica
  (:class:`SLOAdmission`), typed :class:`ShedError`.
- :mod:`.gateway` — stdlib streaming HTTP/SSE server
  (``POST /v1/completions``, ``/healthz``, ``/metrics``).
- :mod:`.journal` — the durable request plane: a CRC'd write-ahead request
  journal plus the keyed table that makes gateway submits idempotent
  (``Idempotency-Key``), SSE streams client-resumable (``Last-Event-ID``),
  and gateway ``kill -9`` recoverable (journal replay re-drives unfinished
  requests through the engines' ``resume_tokens`` machinery).
- :mod:`.loadgen` — deterministic trace-driven load generation for tests and
  the bench frontend extra.
- :mod:`.rpc` / :mod:`.worker` / :mod:`.supervisor` / :mod:`.fleet` — the
  self-healing multi-process fleet: each replica runs its engine in its own
  OS process behind a socket RPC, holds a TTL lease on the membership plane
  (:mod:`paddle_tpu_torch.distributed.membership`), is respawned by a
  crash-loop-aware supervisor, and joins/leaves gateway routing via
  membership events (:class:`FleetReplicaSet`, a ReplicaSet drop-in with
  zero-token crash requeue).

Quick start::

    from paddle_tpu_torch.inference.frontend import ReplicaSet, start_gateway

    rs = ReplicaSet([engine_a, engine_b])           # threads start here
    gw = start_gateway(rs, port=8000)
    ...  # POST http://127.0.0.1:8000/v1/completions
    gw.close(); rs.close()
"""
from .admission import (AdmissionDecision, AlwaysAdmit,  # noqa: F401
                        ShedError, SLOAdmission)
from .fleet import FleetReplicaSet, RemoteReplica  # noqa: F401
from .gateway import Gateway, start_gateway  # noqa: F401
from .journal import (DurableRequest, DurableRequestPlane,  # noqa: F401
                      RequestJournal)
from .loadgen import (http_completion, make_trace,  # noqa: F401
                      run_closed_loop, summarize)
from .replica import (EngineReplica, ReplicaDeadError,  # noqa: F401
                      ReplicaSet, RequestHandle, StuckStepError)
from .router import (PrefixAffinityRouter, RouteDecision,  # noqa: F401
                     RoundRobinRouter)
from .rpc import RpcClient, RpcError, RpcServer  # noqa: F401
from .supervisor import WorkerSupervisor  # noqa: F401
from .worker import WorkerServer  # noqa: F401

__all__ = [
    "ReplicaSet", "EngineReplica", "RequestHandle", "ReplicaDeadError",
    "StuckStepError",
    "PrefixAffinityRouter", "RoundRobinRouter", "RouteDecision",
    "SLOAdmission", "AlwaysAdmit", "AdmissionDecision", "ShedError",
    "Gateway", "start_gateway",
    "RequestJournal", "DurableRequest", "DurableRequestPlane",
    "make_trace", "run_closed_loop", "summarize", "http_completion",
    "RpcServer", "RpcClient", "RpcError",
    "WorkerServer", "WorkerSupervisor",
    "RemoteReplica", "FleetReplicaSet",
]
