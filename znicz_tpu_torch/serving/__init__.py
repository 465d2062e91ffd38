"""Serving: the bucket ladder, the continuous batcher, the one-shot engine
over them, int8 weight quantization, decode (KV caches, the
prefill/decode programs and the token-batching engine), disaggregated
decode (prefill and decode pools joined by page handoffs), the fleet of
many models under per-tenant SLOs with the autoscalers, and the
kernel-library store (port of ``znicz_tpu/serving``)."""

from znicz_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher, DeadlineExceeded, Overloaded, PriorityQueue,
    QueueFull, Request, TokenBucketLimiter, TokenBudget)
from znicz_tpu_torch.serving.buckets import bucket_for, ladder  # noqa: F401
from znicz_tpu_torch.serving.engine import (  # noqa: F401
    ServingEngine, resolve_swap_state)
from znicz_tpu_torch.serving.decode import (  # noqa: F401
    DecodeEngine, DecodeModel, KVCache, PagedKVCache, PoolExhausted,
    PrefixCache)
from znicz_tpu_torch.serving.fleet import (  # noqa: F401
    FleetAutoscaler, FleetEngine, PoolAutoscaler, ReplicaGroup,
    SharedLadderBudget, TenantClass)
from znicz_tpu_torch.serving.disagg import (  # noqa: F401
    DisaggEngine, Handoff)
