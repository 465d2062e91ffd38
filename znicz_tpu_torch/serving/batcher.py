"""Continuous batcher: an async request queue drained into buckets (port of
``znicz_tpu/serving/batcher.py``).

Requests arrive individually; a scheduler thread coalesces whatever is
pending into one batch per dispatch (the Orca insight, Yu et al.,
OSDI 2022).  Policy, as in the reference:

- a flush happens when pending rows reach ``max_batch`` OR the oldest
  pending request has waited ``max_delay_ms`` (the admission window);
- coalescing is FIFO-prefix: requests keep arrival order;
- the queue is bounded in ROWS (``max_queue``): a full queue makes
  :meth:`ContinuousBatcher.submit` raise :class:`QueueFull` at once;
- shutdown drains: everything admitted before :meth:`shutdown` is
  served before the scheduler exits;
- **deadlines** — a request whose ``deadline_ms`` passes while queued
  fails with :class:`DeadlineExceeded` and is evicted before dispatch;
- **retry budget** — a dispatch that raises re-queues its requests at
  the front up to ``retry_budget`` times each before failing them;
- **circuit breaker** — closed → open when the recent-dispatch failure
  rate crosses ``breaker_failure_rate`` or the oldest pending request
  exceeds ``max_queue_age_ms``; while open, :meth:`submit` sheds load
  with :class:`Overloaded`; after ``breaker_cooldown_ms`` the breaker
  goes half-open and the next dispatch decides.

The reference's tenancy (priority classes, per-tenant bounds,
preemption) and request tracing belong to later slices; this queue is
one FIFO class.  The batcher knows nothing about models or devices:
it hands each coalesced batch (a list of :class:`Request`) to the
``run_batch`` callable, which resolves the futures.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.utils.logger import Logger


class QueueFull(RuntimeError):
    """Raised by :meth:`ContinuousBatcher.submit` when the bounded
    request queue has no room — the caller's backpressure signal."""


class Overloaded(QueueFull):
    """Load shed: the circuit breaker is open (recent dispatches
    failing, or the queue has grown stale)."""


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_ms`` passed while it was queued; it
    was evicted before ever reaching a program."""


#: breaker states, also the gauge encoding on /metrics
_CLOSED, _HALF_OPEN, _OPEN = "closed", "half_open", "open"
_STATE_CODE = {_CLOSED: 0, _HALF_OPEN: 1, _OPEN: 2}


class Request:
    """One submitted batch of rows riding the queue."""

    __slots__ = ("x", "n", "future", "t_submit", "deadline", "attempts")

    def __init__(self, x, deadline_ms: float | None = None) -> None:
        self.x = x
        self.n = int(x.shape[0])
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = (None if deadline_ms is None
                         else self.t_submit + float(deadline_ms) / 1e3)
        self.attempts = 0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class ContinuousBatcher(Logger):
    """FIFO request queue + scheduler thread coalescing into batches."""

    def __init__(self, run_batch, *, max_batch: int,
                 max_delay_ms: float = 5.0, max_queue: int = 1024,
                 name: str = "serving", queue_gauge=None,
                 retry_budget: int = 0,
                 breaker_failure_rate: float = 0.5,
                 breaker_window: int = 8,
                 breaker_min_samples: int = 4,
                 breaker_cooldown_ms: float = 1000.0,
                 max_queue_age_ms: float | None = 10_000.0,
                 obs_id: str | None = None) -> None:
        super().__init__()
        if max_queue < max_batch:
            raise ValueError(
                f"max_queue ({max_queue}) must be >= max_batch "
                f"({max_batch}) or full buckets could never form")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.retry_budget = max(0, int(retry_budget))
        self.breaker_failure_rate = float(breaker_failure_rate)
        self.breaker_min_samples = int(breaker_min_samples)
        self.breaker_cooldown = float(breaker_cooldown_ms) / 1e3
        self.max_queue_age = (None if max_queue_age_ms is None
                              else float(max_queue_age_ms) / 1e3)
        #: optional metrics Gauge tracking pending rows live
        self._queue_gauge = queue_gauge
        #: per-engine label for the breaker/deadline registry series
        #: (None = bare batcher: counters tracked locally only)
        self._obs_id = obs_id
        self._m_state = (_metrics.serving_breaker_state(obs_id)
                         if obs_id else None)
        if self._m_state is not None:
            self._m_state.set(_STATE_CODE[_CLOSED])
            _metrics.serving_queue_age_seconds(
                obs_id, pool="all").set_function(self.oldest_age_s)
        self._pending: deque[Request] = deque()
        self._rows = 0
        self._cond = threading.Condition()
        self._stop = False
        self._flush_now = False
        # breaker state (all under _cond)
        self._state = _CLOSED
        self._opened_at = 0.0
        self._outcomes: deque[bool] = deque(maxlen=int(breaker_window))
        # plain counters (stats views; registry series ride obs_id)
        self.expired_total = 0
        self.shed_total = 0
        self.retries_total = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"{name}-batcher", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    @property
    def queue_rows(self) -> int:
        """Rows currently pending (telemetry; racy by nature)."""
        return self._rows

    @property
    def breaker_state(self) -> str:
        return self._state

    def oldest_age_s(self) -> float:
        """Age of the oldest pending request (0 when idle)."""
        try:
            head = self._pending[0]
        except IndexError:
            return 0.0
        return max(0.0, time.monotonic() - head.t_submit)

    # -- row accounting (call under _cond) ------------------------------
    def _account(self, rows: int) -> None:
        self._rows += rows
        if self._queue_gauge is not None:
            self._queue_gauge.set(self._rows)

    def _count(self, event: str, n: int = 1) -> None:
        if self._obs_id:
            _metrics.serving_requests(self._obs_id, event).inc(n)

    # ------------------------------------------------------------------
    # circuit breaker (call under _cond)
    # ------------------------------------------------------------------
    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        self.warning("circuit breaker %s → %s", self._state, state)
        self._state = state
        if state == _OPEN:
            self._opened_at = time.monotonic()
        if self._m_state is not None:
            self._m_state.set(_STATE_CODE[state])
        if self._obs_id:
            _metrics.serving_breaker_transitions(self._obs_id,
                                                 state).inc()

    def _trip(self, why: str) -> None:
        if self._state != _OPEN:
            self.warning("circuit breaker tripped: %s", why)
            self._transition(_OPEN)
            self._outcomes.clear()
            # a stale queue is a stall: force the pending prefix out
            # rather than letting it age further behind the window
            self._flush_now = True
            self._cond.notify_all()

    def _breaker_tick(self, now: float) -> None:
        """Open → half-open after the cooldown; age-trip when the head
        of the queue exceeds the stall threshold."""
        if self._state == _OPEN \
                and now - self._opened_at >= self.breaker_cooldown:
            self._transition(_HALF_OPEN)
        if (self._state == _CLOSED and self.max_queue_age is not None
                and self._pending
                and now - self._pending[0].t_submit > self.max_queue_age):
            self._trip(f"oldest request pending "
                       f"{now - self._pending[0].t_submit:.1f}s "
                       f"(> {self.max_queue_age:.1f}s)")

    def _record_outcome(self, ok: bool) -> None:
        with self._cond:
            if self._state == _HALF_OPEN:
                # the probe decides: healthy again, or back to shedding
                self._transition(_CLOSED if ok else _OPEN)
                self._outcomes.clear()
                return
            self._outcomes.append(ok)
            n = len(self._outcomes)
            if n >= self.breaker_min_samples:
                failure_rate = self._outcomes.count(False) / n
                if failure_rate >= self.breaker_failure_rate:
                    self._trip(f"failure rate {failure_rate:.0%} over "
                               f"last {n} dispatches")

    # ------------------------------------------------------------------
    def submit(self, x, deadline_ms: float | None = None) -> Future:
        """Enqueue a request (``x``: a batch of rows, anything with a
        ``shape``); returns the future of its output rows.

        Raises :class:`QueueFull` when the bounded queue has no room,
        :class:`Overloaded` while the breaker sheds load,
        :class:`DeadlineExceeded` for a non-positive deadline, and
        ``RuntimeError`` after shutdown."""
        req = Request(x, deadline_ms=deadline_ms)
        if req.n < 1 or req.n > self.max_batch:
            raise ValueError(
                f"request of {req.n} rows outside 1..{self.max_batch} "
                f"(max_batch) — split it client-side")
        if deadline_ms is not None and deadline_ms <= 0:
            raise DeadlineExceeded(
                f"deadline_ms={deadline_ms} already expired at submit")
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            self._breaker_tick(time.monotonic())
            if self._state == _OPEN:
                self.shed_total += 1
                self._count("shed")
                raise Overloaded(
                    "circuit breaker open — load shed (retry after "
                    f"{self.breaker_cooldown * 1e3:.0f}ms)")
            if self._rows + req.n > self.max_queue:
                raise QueueFull(
                    f"serving queue full ({self._rows} rows pending, "
                    f"limit {self.max_queue})")
            self._pending.append(req)
            self._account(req.n)
            self._cond.notify_all()
        return req.future

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the scheduler after draining everything pending."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    # ------------------------------------------------------------------
    def _evict_expired(self, now: float) -> None:
        """Fail every pending request whose deadline passed, before
        coalescing.  Call under ``_cond``."""
        if not any(r.expired(now) for r in self._pending):
            return
        keep: deque[Request] = deque()
        for req in self._pending:
            if not req.expired(now):
                keep.append(req)
                continue
            self._account(-req.n)
            self.expired_total += 1
            self._count("expired")
            req.future.set_exception(DeadlineExceeded(
                f"deadline passed after "
                f"{(now - req.t_submit) * 1e3:.0f}ms in queue"))
        self._pending = keep

    def _wait_timeout(self, now: float) -> float:
        """How long the admission wait may sleep: bounded by the window
        remainder, the nearest pending deadline, and a 250 ms
        housekeeping tick (age-trip + eviction responsiveness)."""
        remain = self._pending[0].t_submit + self.max_delay - now
        deadlines = [r.deadline for r in self._pending
                     if r.deadline is not None]
        if deadlines:
            remain = min(remain, max(0.0, min(deadlines) - now))
        if self.max_queue_age is not None:
            remain = min(remain, 0.25)
        return remain

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if not self._pending and self._stop:
                    return
                # admission window: sleep until the batch fills, the
                # oldest request's delay budget runs out, or the
                # breaker forces a flush
                while not self._stop and not self._flush_now:
                    now = time.monotonic()
                    self._evict_expired(now)
                    self._breaker_tick(now)
                    if not self._pending or self._rows >= self.max_batch:
                        break
                    remain = self._wait_timeout(now)
                    if remain <= 0:
                        break
                    self._cond.wait(timeout=remain)
                self._evict_expired(time.monotonic())
                batch: list[Request] = []
                rows = 0
                # FIFO prefix that fits the bucket; no head-of-line skip
                while self._pending \
                        and rows + self._pending[0].n <= self.max_batch:
                    req = self._pending.popleft()
                    rows += req.n
                    batch.append(req)
                    self._account(-req.n)
                self._flush_now = False
                self._cond.notify_all()
            if not batch:  # everything expired / spurious wakeup
                continue
            try:
                self._run_batch(batch)
            except Exception as exc:  # noqa: BLE001 - isolate the batch
                self._record_outcome(False)
                self._dispatch_failed(batch, exc)
            else:
                self._record_outcome(True)
                retried = sum(1 for r in batch if r.attempts)
                if retried:
                    _metrics.recoveries("serving_retry").inc(retried)

    def _dispatch_failed(self, batch: list[Request], exc) -> None:
        """Retry-budget accounting: requests with budget left re-enter
        the FRONT of the queue (order preserved); the rest fail.
        During shutdown nothing retries — the drain must terminate."""
        retry: list[Request] = []
        now = time.monotonic()
        with self._cond:
            for req in batch:
                if (not self._stop and req.attempts < self.retry_budget
                        and not req.expired(now)):
                    req.attempts += 1
                    retry.append(req)
            if retry:
                self.retries_total += len(retry)
                self._count("retried", len(retry))
                self._pending.extendleft(reversed(retry))
                self._account(sum(r.n for r in retry))
                self._cond.notify_all()
        failed = [r for r in batch if r not in retry]
        if failed:
            self.warning("batch of %d requests failed: %s",
                         len(failed), exc)
        for req in failed:
            if not req.future.done():
                req.future.set_exception(exc)
