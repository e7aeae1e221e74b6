"""Online serving of the PyTorch/CUDA port: shard-aware continuous batching
over the streaming decode runtime (the JAX package's ``serve/``, single
engine).

- ``request`` — requests, their status machine and typed outcomes.
- ``queue``   — the admission queue: backpressure, deadline eviction,
  drain and shutdown.
- ``batcher`` — waves admitted at shard-0 boundaries of the weight sweep,
  so a join never prefills an in-flight request again.
- ``engine``  — the serving loop over the streamed or resident weights,
  with the paged prefix-KV pool's suffix-only prefill, the SLO tracker,
  the serving metrics and the stall watchdog.
- ``sched``   — the SLO classes requests carry.

The JAX package's replica fleet and router, request WAL and replay,
speculative serving, sweep scheduler and autoscaler are not ported yet.
"""

from flexible_llm_sharding_tpu_torch.serve.request import (  # noqa: F401
    DeadlineExceeded,
    QueueFull,
    Request,
    RequestResult,
    RequestStatus,
    RequestTooLarge,
    ServeClosed,
    ServeFuture,
    WaveAborted,
)
from flexible_llm_sharding_tpu_torch.serve.queue import AdmissionQueue  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.batcher import ShardAwareBatcher  # noqa: F401
from flexible_llm_sharding_tpu_torch.serve.engine import ServeEngine  # noqa: F401
