"""One-shot serving: the bucket ladder, the continuous batcher and the
engine over them (port of ``znicz_tpu/serving``)."""

from znicz_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher, DeadlineExceeded, Overloaded, QueueFull, Request)
from znicz_tpu_torch.serving.buckets import bucket_for, ladder  # noqa: F401
from znicz_tpu_torch.serving.engine import ServingEngine  # noqa: F401
