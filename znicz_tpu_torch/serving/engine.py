"""ServingEngine: throughput-oriented serving over the export format (port
of ``znicz_tpu/serving/engine.py``).

Two pieces on top of :class:`znicz_tpu_torch.export.ExportedModel`:

1. **Warmed bucket ladder** — :meth:`ServingEngine.start` runs every
   bucket of the power-of-two ladder once, so steady-state serving
   pays no first-launch cost and at most ``log2(max_batch)+1``
   programs are resident however ragged the traffic is.
2. **Continuous batching** — :meth:`ServingEngine.submit` enqueues
   onto a bounded queue drained by a scheduler thread
   (:class:`~znicz_tpu_torch.serving.batcher.ContinuousBatcher`) that
   coalesces pending requests into the smallest covering bucket, pads
   the tail, and slices the padded rows out of every reply.  Callers
   see :class:`QueueFull` backpressure, never a server OOM.

Host staging: each bucket owns TWO host buffers (pinned on the card)
used alternately, so refilling one never touches a buffer an upload
still in flight may read, and nothing is allocated per request.  The
scheduler thread launches on the current stream, runs under
``torch.inference_mode()``, and copies each reply to the host before
it resolves the futures.

Telemetry: the counters live in the port's metrics registry under
per-engine labels (``znicz_serving_requests_total``,
``znicz_serving_latency_seconds``, ``znicz_serving_queue_rows``,
per-bucket batch/row counters); :meth:`ServingEngine.stats` is a view
over them plus an exact sliding window for the latency percentiles.

Hot swap, the SDC shadow audit, fault sites, request tracing and
replication over several GPUs belong to later slices.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.serving.batcher import (ContinuousBatcher,
                                             DeadlineExceeded, Overloaded,
                                             QueueFull)
from znicz_tpu_torch.serving.buckets import bucket_for, ladder
from znicz_tpu_torch.utils.logger import Logger

__all__ = ["ServingEngine", "QueueFull", "Overloaded", "DeadlineExceeded"]

#: distinguishes same-named engines in the registry's labels
_ENGINE_SEQ = itertools.count()


class ServingEngine(Logger):
    """Continuous-batching server over an exported forward chain.

    ``model`` is an :class:`~znicz_tpu_torch.export.ExportedModel` or a
    bundle path (then loaded on ``device``: the GPU unless the caller
    passes ``device="cpu"``).

    Lifecycle::

        with ServingEngine("model.npz", max_batch=16) as eng:
            future = eng.submit(x)          # async
            probs = future.result()
            probs = eng(x)                  # sync convenience
    """

    def __init__(self, model, *, max_batch: int = 64,
                 max_delay_ms: float = 5.0, max_queue: int | None = None,
                 device=None,
                 retry_budget: int = 1,
                 breaker_failure_rate: float = 0.5,
                 breaker_window: int = 8,
                 breaker_cooldown_ms: float = 1000.0,
                 max_queue_age_ms: float | None = 10_000.0) -> None:
        super().__init__()
        from znicz_tpu_torch.export import ExportedModel
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.max_queue = int(max_queue if max_queue is not None
                             else max(4 * max_batch, 1024))
        self.retry_budget = int(retry_budget)
        self.breaker_failure_rate = float(breaker_failure_rate)
        self.breaker_window = int(breaker_window)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.max_queue_age_ms = max_queue_age_ms
        if isinstance(model, (str, bytes)) or hasattr(model, "__fspath__"):
            model = ExportedModel.load(model, device=device,
                                       max_batch=self.max_batch)
        elif device is not None:
            raise ValueError("device applies to a bundle path; a built "
                             "ExportedModel keeps its own")
        self.model = model
        self.device = model.device
        self._batcher: ContinuousBatcher | None = None
        self._staging: dict[int, list[torch.Tensor]] = {}
        self._flip: dict[int, int] = {}
        self._lock = threading.Lock()
        wf_name = self.model.manifest.get("workflow", "model")
        self._obs_id = f"{wf_name}#{next(_ENGINE_SEQ)}"
        self._m_submitted = _metrics.serving_requests(
            self._obs_id, "submitted")
        self._m_served = _metrics.serving_requests(self._obs_id, "served")
        self._m_rejected = _metrics.serving_requests(
            self._obs_id, "rejected")
        self._m_latency = _metrics.serving_latency_seconds(self._obs_id)
        self._m_queue = _metrics.serving_queue_rows(self._obs_id)
        self._m_warmup = _metrics.serving_warmup_seconds(self._obs_id)
        #: bucket size → (batches counter, rows counter)
        self._m_bucket: dict[int, tuple] = {}
        #: exact-value sliding window for the dashboard percentiles
        self._lat = deque(maxlen=4096)  # enqueue→reply seconds
        self.warmup_programs = 0
        self.warmup_seconds = 0.0
        self._started = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _staging_pair(self, size: int) -> list[torch.Tensor]:
        shape = (size,) + self.model.input_shape
        pin = self.device.type == "cuda"
        return [torch.zeros(shape, dtype=self.model.dtype,
                            pin_memory=pin) for _ in range(2)]

    def start(self) -> "ServingEngine":
        """Warm the whole bucket ladder and start the scheduler
        thread."""
        if self._started:
            return self
        t0 = time.monotonic()
        self.warmup_programs = self.model.warmup(self.max_batch)
        self.warmup_seconds = time.monotonic() - t0
        for size in ladder(self.max_batch):
            self._staging[size] = self._staging_pair(size)
            self._flip[size] = 0
        self._m_warmup.set(self.warmup_seconds)
        self._batcher = ContinuousBatcher(
            self._run_batch, max_batch=self.max_batch,
            max_delay_ms=self.max_delay_ms, max_queue=self.max_queue,
            name=self.model.manifest.get("workflow", "model"),
            queue_gauge=self._m_queue,
            retry_budget=self.retry_budget,
            breaker_failure_rate=self.breaker_failure_rate,
            breaker_window=self.breaker_window,
            breaker_cooldown_ms=self.breaker_cooldown_ms,
            max_queue_age_ms=self.max_queue_age_ms,
            obs_id=self._obs_id)
        self._started = True
        self.info("serving '%s' on %s: %d programs warmed in %.2fs "
                  "(buckets %s)",
                  self.model.manifest.get("workflow", "?"), self.device,
                  self.warmup_programs, self.warmup_seconds,
                  ladder(self.max_batch))
        return self

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain the queue, stop the scheduler."""
        if self._batcher is not None:
            self._batcher.shutdown(timeout=timeout)
            self._batcher = None
        self._started = False

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, x, deadline_ms: float | None = None) -> Future:
        """Enqueue a request (``x``: 1..max_batch rows of samples);
        returns a future of the output rows (float32 numpy).  Raises
        :class:`QueueFull` under backpressure and :class:`Overloaded`
        while the breaker sheds load; with ``deadline_ms`` the future
        fails with :class:`DeadlineExceeded` if the request is still
        queued when the deadline passes."""
        if self._batcher is None:
            raise RuntimeError("engine not started — call start()")
        x = self.model._as_input(x)
        try:
            future = self._batcher.submit(x, deadline_ms=deadline_ms)
        except QueueFull:  # includes Overloaded load shedding
            self._m_rejected.inc()
            raise
        self._m_submitted.inc()
        return future

    def __call__(self, x, timeout: float | None = None,
                 deadline_ms: float | None = None) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(x, deadline_ms=deadline_ms).result(
            timeout=timeout)

    def _run_batch(self, batch) -> None:
        """Scheduler-thread dispatch: coalesce → pad → one program →
        split replies."""
        total = sum(req.n for req in batch)
        size = bucket_for(total)
        staging = self._staging.get(size)
        if staging is None:  # bucket above the warmed ladder
            staging = self._staging[size] = self._staging_pair(size)
            self._flip[size] = 0
        self._flip[size] ^= 1
        buf = staging[self._flip[size]]
        row = 0
        for req in batch:
            buf[row:row + req.n] = req.x
            row += req.n
        if row < size:
            buf[row:] = 0  # padded tail: never leaks, but keep it clean
        with torch.inference_mode():
            out = self.model.program_for(size)(buf)
            out = out[:total].float().cpu().numpy()
        now = time.monotonic()
        row = 0
        for req in batch:
            req.future.set_result(np.array(out[row:row + req.n],
                                           copy=True))
            row += req.n
        self._m_served.inc(len(batch))
        with self._lock:
            pair = self._m_bucket.get(size)
            if pair is None:
                pair = self._m_bucket[size] = (
                    _metrics.serving_bucket_batches(self._obs_id, size),
                    _metrics.serving_bucket_rows(self._obs_id, size))
            pair[0].inc()
            pair[1].inc(total)
            for req in batch:
                lat = now - req.t_submit
                self._lat.append(lat)
                self._m_latency.observe(lat)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    @property
    def requests_submitted(self) -> int:
        return int(self._m_submitted.value)

    @property
    def requests_served(self) -> int:
        return int(self._m_served.value)

    @property
    def requests_rejected(self) -> int:
        return int(self._m_rejected.value)

    def stats(self) -> dict:
        """The engine's live snapshot — a view over its children in the
        metrics registry, plus exact windowed latency percentiles."""
        with self._lock:
            lat = sorted(self._lat)
            buckets = {}
            for size in sorted(self._m_bucket):
                batches_c, rows_c = self._m_bucket[size]
                batches, rows = int(batches_c.value), int(rows_c.value)
                buckets[size] = {
                    "batches": batches,
                    "rows": rows,
                    "occupancy_pt": round(
                        100.0 * rows / (batches * size), 1),
                }
        b = self._batcher
        out = {
            "engine": "bucketed-eager",
            "device": str(self.device),
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_ms,
            "buckets_warmed": sorted(self._staging),
            "programs_built": self.model.programs_built,
            "warmup_seconds": round(self.warmup_seconds, 3),
            "submitted": self.requests_submitted,
            "served": self.requests_served,
            "rejected": self.requests_rejected,
            "queue_rows": b.queue_rows if b else 0,
            "buckets": buckets,
            "resilience": {
                "breaker": b.breaker_state if b else "closed",
                "retry_budget": self.retry_budget,
                "retried": b.retries_total if b else 0,
                "expired": b.expired_total if b else 0,
                "shed": b.shed_total if b else 0,
                "queue_age_ms": round(1e3 * b.oldest_age_s(), 1)
                if b else 0.0,
            },
        }
        if lat:
            pct = _metrics._percentile
            out["latency_ms"] = {
                "p50": round(1e3 * pct(lat, 50), 3),
                "p95": round(1e3 * pct(lat, 95), 3),
                "p99": round(1e3 * pct(lat, 99), 3),
                "mean": round(1e3 * sum(lat) / len(lat), 3),
                "window": len(lat),
            }
        return out
