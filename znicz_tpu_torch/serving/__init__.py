"""One-shot serving: the bucket ladder, the continuous batcher, the engine
over them and int8 weight quantization (port of
``znicz_tpu/serving``)."""

from znicz_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher, DeadlineExceeded, Overloaded, PriorityQueue,
    QueueFull, Request, TokenBucketLimiter, TokenBudget)
from znicz_tpu_torch.serving.buckets import bucket_for, ladder  # noqa: F401
from znicz_tpu_torch.serving.engine import (  # noqa: F401
    ServingEngine, resolve_swap_state)
