"""Online serving of the PyTorch/CUDA port: shard-aware continuous batching
over the streaming decode runtime (the JAX package's ``serve/``, single
engine).

- ``request`` — requests, their status machine and typed outcomes.
- ``queue``   — the admission queue: backpressure, deadline eviction,
  drain and shutdown.
- ``batcher`` — waves admitted at shard-0 boundaries of the weight sweep,
  so a join never prefills an in-flight request again.
- ``engine``  — the serving loop over the streamed or resident weights,
  with the paged prefix-KV pool's suffix-only prefill, speculative verify
  passes, the SLO tracker, the serving metrics and the stall watchdog.
- ``sched``   — SLO classes, the sweep scheduler (class priority, tenant
  fair queueing and rate limits, preemption) and prefix coalescing.
- ``spec``    — the adaptive draft depth per SLO class.
- ``wal``     — the durable request write-ahead log.
- ``recovery`` — the warm restart: replaying the WAL's open requests.
- ``router``  — the replica fleet's shard-phase ranking.
- ``autoscale`` — the fleet's autoscaler and sweep-phase stagger.
- ``fleet``   — N engines behind the router: exactly-once re-dispatch
  under replica chaos, health monitoring, elastic join and leave.

LoRA adapters are ``flexible_llm_sharding_tpu_torch.adapters``.
"""

from flexible_llm_sharding_tpu_torch.serve.request import (  # noqa: F401
    DeadlineExceeded,
    QueueFull,
    Request,
    RequestResult,
    RequestStatus,
    RequestTooLarge,
    RestartPending,
    ServeClosed,
    ServeFuture,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.serve.queue import AdmissionQueue  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.batcher import ShardAwareBatcher  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.wal import RequestWAL  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.router import Router  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.fleet import ReplicaFleet, ReplicaKilled  # noqa: F401
