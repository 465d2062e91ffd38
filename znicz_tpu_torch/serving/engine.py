"""ServingEngine: throughput-oriented serving over the export format (port
of ``znicz_tpu/serving/engine.py``).

Two pieces on top of :class:`znicz_tpu_torch.export.ExportedModel`:

1. **Warmed bucket ladder** — :meth:`ServingEngine.start` makes every
   bucket of the power-of-two ladder resident (on the card: captures
   its CUDA graph), so steady-state serving pays no first-launch cost
   and no capture, and at most ``log2(max_batch)+1`` programs are
   resident however ragged the traffic is.
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

Hot swap (:meth:`ServingEngine.swap_weights`): the candidate is
validated and staged on the device by the calling thread, then
published on the scheduler thread between two dispatches
(``ContinuousBatcher.run_between``): one device-to-device copy into the
tensors the graphs read, so a reply is the old weights' or the new
ones', never a mix, and no bucket is captured again.  Each outcome is
counted (``znicz_swaps_total``) and journaled to the flight recorder.

The sampled SDC shadow audit (``shadow_audit_rate``, or
``root.common.serving.sdc_audit_rate``) re-scores a fraction of the
batches on the numpy oracle (an ``ExportedModel(device="numpy")`` over
the current weights, rebuilt when ``weights_version`` moves); a reply
off by more than ``sdc_audit_rtol`` marks the engine suspect, is
corrected from the oracle, and fires ``on_sdc_suspect`` once.  The
fault sites ``serving.latency_spike``, ``serving.program_error`` and
``sdc.serving_bitflip`` fire in the dispatch.

Replication over several GPUs belongs to ROADMAP A9.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import recorder as _recorder
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.serving.batcher import (ContinuousBatcher,
                                             DeadlineExceeded, Overloaded,
                                             QueueFull)
from znicz_tpu_torch.serving.buckets import bucket_for, ladder
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger

__all__ = ["ServingEngine", "QueueFull", "Overloaded",
           "DeadlineExceeded", "resolve_swap_state"]


def resolve_swap_state(state) -> tuple:
    """A swap source as ``(manifest, params)``: a bundle path, an
    :class:`~znicz_tpu_torch.export.ExportedModel`, an already-read
    ``(manifest, params)`` pair, or a plain ``{layer<i>_<attr>: array}``
    dict (then the manifest is None and only shapes are checked)."""
    from znicz_tpu_torch.export import ExportedModel, read_bundle
    if isinstance(state, ExportedModel):
        return state.manifest, dict(state._params)
    if isinstance(state, (str, bytes)) or hasattr(state, "__fspath__"):
        return read_bundle(state)
    if isinstance(state, tuple) and len(state) == 2 \
            and isinstance(state[1], dict):
        return state
    if isinstance(state, dict):
        return None, state
    raise TypeError(f"cannot swap from {type(state).__name__}: pass a "
                    f"bundle path, an ExportedModel or a params dict")

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
                 max_queue_age_ms: float | None = 10_000.0,
                 shadow_audit_rate: float | None = None) -> None:
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
        # hot swap
        self.model_version = 0
        self._m_version = _metrics.model_version(self._obs_id)
        self._m_version.set(0)
        self._m_swap_dur = _metrics.swap_duration_seconds(self._obs_id)
        self.swap_counts = {"promoted": 0, "rejected": 0,
                            "rolled_back": 0}
        self._swap_pauses: list[float] = []  # seconds, per swap
        self._swap_stages: list[float] = []
        # the sampled SDC shadow audit
        self.shadow_audit_rate = float(
            root.common.serving.get("sdc_audit_rate", 0.0)
            if shadow_audit_rate is None else shadow_audit_rate)
        self.sdc_audit_rtol = float(
            root.common.serving.get("sdc_audit_rtol", 0.05))
        #: replica identity for sdc.serving_bitflip's context filter
        self.sdc_replica = self._obs_id
        #: ``callable(engine)`` called once, on the first mismatch
        self.on_sdc_suspect = None
        self.sdc_suspect = False
        self._audit_acc = 0.0
        self._audit_stats = {"audited": 0, "mismatched": 0}
        self._audit_seconds = 0.0
        self._oracle = None
        self._oracle_version = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _staging_pair(self, size: int) -> list[torch.Tensor]:
        shape = (size,) + self.model.input_shape
        pin = self.device.type == "cuda"
        return [torch.zeros(shape, dtype=self.model.serve_dtype,
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
                  "(buckets %s, %d captured)",
                  self.model.manifest.get("workflow", "?"), self.device,
                  self.warmup_programs, self.warmup_seconds,
                  ladder(self.max_batch), self.model.captures)
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
    def submit(self, x, deadline_ms: float | None = None, *,
               tenant: str | None = None, priority: int = 0,
               retry_budget: int | None = None,
               tenant_max_rows: int | None = None) -> Future:
        """Enqueue a request (``x``: 1..max_batch rows of samples);
        returns a future of the output rows (float32 numpy).  Raises
        :class:`QueueFull` under backpressure and :class:`Overloaded`
        while the breaker sheds load; with ``deadline_ms`` the future
        fails with :class:`DeadlineExceeded` if the request is still
        queued when the deadline passes.  ``tenant``, ``priority``,
        ``retry_budget`` and ``tenant_max_rows`` are the batcher's
        tenancy knobs (:meth:`ContinuousBatcher.submit`)."""
        if self._batcher is None:
            raise RuntimeError("engine not started — call start()")
        x = self.model._as_input(x)
        try:
            future = self._batcher.submit(
                x, deadline_ms=deadline_ms, tenant=tenant,
                priority=priority, retry_budget=retry_budget,
                tenant_max_rows=tenant_max_rows)
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

    def flush(self) -> None:
        """Dispatch pending requests without waiting out the admission
        window."""
        if self._batcher is not None:
            self._batcher.flush()

    # ------------------------------------------------------------------
    # weight hot-swap
    # ------------------------------------------------------------------
    def current_bundle(self) -> tuple:
        """The live ``(manifest, params)``, host arrays."""
        return self.model.manifest, dict(self.model._params)

    def swap_weights(self, state, *, version: int | None = None,
                     outcome: str = "promoted") -> dict:
        """Hot-swap the served weights with no new capture.

        ``state`` is a bundle path, an ``ExportedModel`` or a params
        dict (:func:`resolve_swap_state`).  It is validated against the
        manifest first (:class:`~znicz_tpu_torch.export.SwapIncompatible`
        leaves the incumbent untouched) and staged on the device by this
        thread; the scheduler thread then publishes it between two
        dispatches.  ``outcome`` labels the ``znicz_swaps_total`` event.
        Returns a summary: the version, the publish's pause and the
        staging time."""
        manifest, params = resolve_swap_state(state)
        staged = self.model.stage_weights(params, manifest)
        publish = functools.partial(self.model.publish, staged)
        b = self._batcher
        pause = b.run_between(publish) if b is not None else publish()
        self.model_version = int(self.model_version + 1 if version is None
                                 else version)
        self._m_version.set(self.model_version)
        self._m_swap_dur.observe(staged.seconds + pause)
        self._swap_pauses.append(pause)
        self._swap_stages.append(staged.seconds)
        self.record_swap_outcome(outcome)
        self.info("weights hot-swapped → version %d (%s, staged in %.1f "
                  "ms, published in %.3f ms, no new capture)",
                  self.model_version, outcome, 1e3 * staged.seconds,
                  1e3 * pause)
        return {"version": self.model_version, "outcome": outcome,
                "pause_ms": round(1e3 * pause, 3),
                "stage_ms": round(1e3 * staged.seconds, 3),
                "weights_version": self.model.weights_version}

    def record_swap_outcome(self, outcome: str) -> None:
        """Count one swap verdict for this engine and journal it to the
        flight recorder."""
        self.swap_counts[outcome] = self.swap_counts.get(outcome, 0) + 1
        _metrics.swaps_total(self._obs_id, outcome).inc()
        _recorder.record("swap", engine=self._obs_id, outcome=outcome,
                         version=self.model_version)

    def set_model_version(self, version: int) -> None:
        """Label the loaded bundle's published version."""
        self.model_version = int(version)
        self._m_version.set(self.model_version)

    def swap_pauses_ms(self) -> list[float]:
        """Each swap's publish pause (ms): the time dispatches waited."""
        return [1e3 * p for p in self._swap_pauses]

    def swap_stages_ms(self) -> list[float]:
        """Each swap's staging time (ms), off the dispatch path."""
        return [1e3 * p for p in self._swap_stages]

    # ------------------------------------------------------------------
    def _run_batch(self, batch) -> None:
        """Scheduler-thread dispatch: coalesce → pad → one program →
        split replies."""
        spike = _faults.fire("serving.latency_spike")
        if spike is not None:  # chaos: a slow program / stalled device
            time.sleep(float(spike.get("ms", 50.0)) / 1e3)
        if _faults.fire("serving.program_error") is not None:
            raise _faults.FaultInjected(
                "injected serving program failure")
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
        with self.model._lock, torch.inference_mode():
            out = self.model.program_for(size)(buf)
            out = out[:total].float().cpu().numpy()
        out = self._shadow_audit(buf, out, total)
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
    # the sampled SDC shadow audit
    # ------------------------------------------------------------------
    def _shadow_oracle(self):
        """The numpy oracle over the current weights (rebuilt after a
        swap)."""
        if self._oracle is None \
                or self._oracle_version != self.model.weights_version:
            from znicz_tpu_torch.export import ExportedModel
            manifest, params = self.current_bundle()
            self._oracle = ExportedModel(dict(manifest), params,
                                         device="numpy")
            self._oracle_version = self.model.weights_version
        return self._oracle

    def _shadow_audit(self, buf, out: np.ndarray, rows: int) -> np.ndarray:
        """Scheduler-thread tail of a dispatch: apply the seeded
        ``sdc.serving_bitflip`` (chaos), then, for the sampled fraction
        of batches (``shadow_audit_rate``; every batch once suspect),
        score the real rows again on the numpy oracle.  A mismatch
        marks the engine suspect, corrects the reply from the oracle
        (the caller never receives the wrong answer) and calls
        ``on_sdc_suspect`` once."""
        flip = _faults.fire("sdc.serving_bitflip",
                            replica=self.sdc_replica)
        if flip is not None:
            out = np.array(out, copy=True)
            out[:, 0] = out[:, 0] * float(flip.get("factor", 2.0 ** 14))
        rate = self.shadow_audit_rate
        if rate <= 0.0 and not self.sdc_suspect:
            return out
        self._audit_acc += rate
        audit = self.sdc_suspect or self._audit_acc >= 1.0
        if self._audit_acc >= 1.0:
            self._audit_acc -= 1.0
        if not audit or rows == 0:
            return out
        t0 = time.perf_counter()
        ref = self._shadow_oracle()(buf[:rows].float().numpy())
        got = np.asarray(out[:rows], dtype=np.float32)
        self._audit_stats["audited"] += 1
        scale = np.maximum(np.abs(ref), 1.0)
        ok = bool(np.all(np.abs(got - ref) <= self.sdc_audit_rtol * scale))
        self._audit_seconds += time.perf_counter() - t0
        if ok:
            return out
        self._audit_stats["mismatched"] += 1
        first = not self.sdc_suspect
        self.sdc_suspect = True
        # process index 0: one process until ROADMAP A9's process_shard
        _metrics.sdc_suspects(0, self.sdc_replica).inc()
        if first:
            _metrics.sdc_detected("serving").inc()
            self.error(
                "SDC shadow audit: replica %s returned wrong scores "
                "(max dev %.3g) — reply corrected from the oracle, "
                "replica marked suspect", self.sdc_replica,
                float(np.max(np.abs(got - ref))))
        out = np.array(out, copy=True)
        out[:rows] = ref.astype(out.dtype)
        if first and self.on_sdc_suspect is not None:
            try:
                self.on_sdc_suspect(self)
            except Exception as exc:  # noqa: BLE001 — audit must not fail
                self.error("on_sdc_suspect hook failed: %s", exc)
        return out

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
        m = self.model
        audited = self._audit_stats["audited"]
        out = {
            "engine": "bucketed-graphs" if m.graphed else "bucketed-eager",
            "device": "numpy" if m.host_only else str(self.device),
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_ms,
            "buckets_warmed": sorted(self._staging),
            "programs": {"built": m.programs_built,
                         "live": len(m._programs),
                         "captures": m.captures,
                         "graphed": m.graphed},
            "warmup_seconds": round(self.warmup_seconds, 3),
            "submitted": self.requests_submitted,
            "served": self.requests_served,
            "rejected": self.requests_rejected,
            "model_version": self.model_version,
            "weights_version": m.weights_version,
            "swaps": dict(self.swap_counts),
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
                "sdc": {"audit_rate": self.shadow_audit_rate,
                        "suspect": self.sdc_suspect,
                        **self._audit_stats,
                        "audit_ms_mean": round(
                            1e3 * self._audit_seconds / audited, 3)
                        if audited else 0.0},
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

    def ready(self) -> bool:
        """The readiness signal: started and not shedding load."""
        b = self._batcher
        return bool(self._started and b is not None
                    and b.breaker_state != "open")

    def serving_status(self) -> dict:
        """The status page's entry for this engine."""
        out = {"name": f"serving:{self.model.manifest.get('workflow', '?')}",
               "initialized": self._started,
               "stopped": not self._started}
        out.update(self.stats())
        out["backend"] = "numpy" if self.model.host_only \
            else self.device.type
        return out
