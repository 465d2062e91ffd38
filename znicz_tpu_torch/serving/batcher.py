"""Continuous batcher: an async request queue drained into buckets (port of
``znicz_tpu/serving/batcher.py``).

The Orca insight (Yu et al., OSDI 2022) applied to this framework's
forward path: requests arrive asynchronously and individually, but the
accelerator wants large batches — so a scheduler thread coalesces
whatever is pending into one batch per dispatch, instead of locking
the serving loop to fixed request boundaries.

Policy (all knobs on the constructor):

- a flush happens when pending rows reach ``max_batch`` (full bucket)
  OR the **oldest** pending request has waited ``max_delay_ms`` (the
  admission window: a lone size-1 request is never parked behind an
  empty queue for long);
- coalescing is FIFO-prefix: requests keep arrival order and are never
  reordered past each other, so per-caller ordering holds;
- the queue is bounded in ROWS (``max_queue``): when it is full,
  :meth:`submit` raises :class:`QueueFull` immediately — callers see
  backpressure, the server never queues itself into OOM;
- shutdown drains: everything admitted before :meth:`shutdown` is
  served before the scheduler exits.

Resilience (graceful degradation under in-flight faults):

- **deadlines** — ``submit(x, deadline_ms=…)``; a request whose
  deadline passes while queued fails fast with
  :class:`DeadlineExceeded` and is **evicted before dispatch** — a
  timed-out caller's rows never occupy a bucket;
- **retry budget** — a dispatch that raises re-queues its requests at
  the queue front up to ``retry_budget`` times each (0 = the
  fail-the-batch behavior) before failing their futures; a
  request served after a retry counts a
  ``znicz_recoveries_total{kind=serving_retry}``;
- **circuit breaker** — closed → open when the recent-dispatch
  failure rate crosses ``breaker_failure_rate`` (over a
  ``breaker_window`` outcome window, min ``breaker_min_samples``) or
  the oldest pending request exceeds ``max_queue_age_ms``; while open,
  :meth:`submit` sheds load with a fast :class:`Overloaded` (a
  ``QueueFull`` subclass, so existing backpressure handling still
  catches it); after ``breaker_cooldown_ms`` the breaker goes
  half-open and the next dispatch outcome decides (success → closed,
  failure → open again).  Every transition is a registry counter and
  the live state a gauge (``/metrics``, ``/readyz``).

Tenancy (the fleet's admission plane): every request may
carry a ``tenant`` + ``priority``.  Pending requests live in priority
CLASSES — strict priority across classes (smaller number dispatches
first), FIFO within a class — so a low-priority flood can delay a
high-priority request by at most the dispatch already in flight.  The
row bound becomes preemptive: when the queue is full and a
higher-priority request arrives, the NEWEST lower-priority rows are
shed (:class:`Overloaded`) to make room — the flooding class absorbs
its own overload.  Per-request ``retry_budget`` overrides the engine
default (per-tenant SLOs), per-tenant row bounds
(``tenant_max_rows``) cap any one tenant's share of the queue, and
the breaker's stall-trip watches the HIGHEST-priority head only — a
starved low class is a shedding/deadline problem for that class, not
evidence of a stalled device.

Every request carries a :class:`~znicz_tpu_torch.observe.tracing.RequestTrace`
(its ``queue`` phase, then its ``decode`` phase: the coalesced
dispatch), each dispatch runs in a ``serve_batch`` span, and each
breaker transition is journaled to the flight recorder.

:meth:`ContinuousBatcher.run_between` runs a callable on the scheduler
thread between two dispatches (the engine publishes a hot-swapped
weight set through it).  :class:`TokenBudget` and
:class:`TokenBucketLimiter` live here as in the reference, for the
decode and fleet planes that import them.

The batcher knows nothing about models or devices — it hands each
coalesced batch (a list of :class:`Request`) to the ``run_batch``
callable and that callable resolves the futures.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import recorder as _recorder
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.utils.logger import Logger


class QueueFull(RuntimeError):
    """Raised by :meth:`ContinuousBatcher.submit` when the bounded
    request queue has no room — the caller's backpressure signal."""


class Overloaded(QueueFull):
    """Load shed: the circuit breaker is open (recent dispatches
    failing, or the queue has grown stale) — the caller gets this
    reply in microseconds instead of a future that times out."""


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_ms`` passed while it was queued; it
    was evicted before ever reaching a program."""


#: breaker states, also the gauge encoding on /metrics
_CLOSED, _HALF_OPEN, _OPEN = "closed", "half_open", "open"
_STATE_CODE = {_CLOSED: 0, _HALF_OPEN: 1, _OPEN: 2}


class TokenBudget:
    """Token-denominated admission budget.

    The row-bounded queue above fits one-shot scoring, where every
    request costs one program dispatch; a *decode* queue holds work
    proportional to ``prompt + max_new_tokens`` TOKENS per request,
    and the paged KV pool's capacity is tokens too — so the decode
    engine bounds admission in the same currency.  ``try_acquire`` is
    non-blocking (admission control wants an immediate
    :class:`QueueFull`, never a hidden wait); ``release`` returns a
    request's charge when it completes, fails or expires.

    The accounting contract is exactly-once: a
    reservation must be released exactly one time across every exit
    path (served, dispatch-failed after retries, deadline-evicted,
    preempted, shed at the pool) — a retry that re-queues a request
    at the queue front KEEPS its reservation (the work is still
    pending).  A release that exceeds what is held does not clamp
    silently: it is counted on :attr:`over_released` (and the excess
    discarded), so a double-release shows up as a nonzero counter in
    the accounting tests instead of as quiet over-admission."""

    __slots__ = ("capacity", "_used", "_lock", "over_released")

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"need capacity >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._used = 0
        self._lock = threading.Lock()
        #: tokens released beyond what was held — MUST stay 0; any
        #: nonzero value is a double-release bug in a caller
        self.over_released = 0

    @property
    def used(self) -> int:
        return self._used

    @property
    def available(self) -> int:
        return self.capacity - self._used

    def try_acquire(self, n: int) -> bool:
        n = int(n)
        with self._lock:
            # a request bigger than the whole budget must still be
            # admissible when the queue is empty, or it could never
            # run at all — the pool-fit check downstream decides
            if self._used + n > self.capacity and self._used > 0:
                return False
            self._used += n
            return True

    def release(self, n: int) -> None:
        n = int(n)
        with self._lock:
            if n > self._used:
                self.over_released += n - self._used
                n = self._used
            self._used -= n

    def balanced(self) -> bool:
        """True when every reservation was returned exactly once —
        nothing outstanding, nothing over-released (assert this when
        the owning queue is idle)."""
        with self._lock:
            return self._used == 0 and self.over_released == 0


class TokenBucketLimiter:
    """Classic token-bucket rate limiter: ``rate`` units
    refill per second up to ``burst``; ``try_acquire`` is non-blocking
    — admission control sheds instead of waiting.  ``rate=None``
    disables limiting (always admits).  Thread-safe; refill is
    computed lazily from the monotonic clock, so an idle bucket needs
    no timer thread."""

    __slots__ = ("rate", "burst", "_level", "_t_last", "_lock")

    def __init__(self, rate: float | None, burst: float | None = None
                 ) -> None:
        self.rate = None if rate is None else float(rate)
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"need rate > 0 (or None), got {rate}")
        self.burst = float(burst if burst is not None
                           else (self.rate or 1.0))
        if self.burst <= 0:
            raise ValueError(f"need burst > 0, got {burst}")
        self._level = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._level = min(self.burst, self._level
                          + (now - self._t_last) * (self.rate or 0.0))
        self._t_last = now

    @property
    def level(self) -> float:
        """Current token level (telemetry)."""
        if self.rate is None:
            return self.burst
        with self._lock:
            self._refill(time.monotonic())
            return self._level

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.rate is None:
            return True
        with self._lock:
            self._refill(time.monotonic())
            if self._level < n:
                return False
            self._level -= n
            return True


class PriorityQueue:
    """Pending requests in strict priority classes.

    Smaller ``priority`` dispatches first; FIFO within a class.  Works
    for any request object carrying ``priority``, ``n`` (rows/tokens)
    and ``t_submit``.  NOT thread-safe — callers hold their own
    condition lock (the batcher's ``_cond``)."""

    __slots__ = ("_classes",)

    def __init__(self) -> None:
        self._classes: dict[int, deque] = {}

    def append(self, req) -> None:
        prio = int(getattr(req, "priority", 0))
        self._classes.setdefault(prio, deque()).append(req)

    def appendleft(self, req) -> None:
        prio = int(getattr(req, "priority", 0))
        self._classes.setdefault(prio, deque()).appendleft(req)

    def requeue_front(self, reqs) -> None:
        """Retry path: requests re-enter the FRONT of their own
        class, original order preserved."""
        for req in reversed(list(reqs)):
            self.appendleft(req)

    def peek(self):
        """The request that would dispatch next (None when empty)."""
        for prio in sorted(self._classes):
            q = self._classes[prio]
            if q:
                return q[0]
        return None

    def popleft(self):
        for prio in sorted(self._classes):
            q = self._classes[prio]
            if q:
                req = q.popleft()
                if not q:
                    del self._classes[prio]
                return req
        raise IndexError("pop from empty PriorityQueue")

    def __len__(self) -> int:
        # telemetry readers (stats, gauges) call this without the
        # owner's lock — retry on a concurrent class-dict mutation
        try:
            return sum(len(q) for q in self._classes.values())
        except RuntimeError:
            return sum(len(q) for q in list(self._classes.values()))

    def __bool__(self) -> bool:
        try:
            return any(self._classes.values())
        except RuntimeError:
            return any(list(self._classes.values()))

    def __iter__(self):
        for prio in sorted(self._classes):
            yield from list(self._classes[prio])

    def oldest_t(self) -> float | None:
        """Submit time of the oldest pending request across ALL
        classes (admission-window clock + queue-age telemetry)."""
        heads = [q[0].t_submit for q in self._classes.values() if q]
        return min(heads) if heads else None

    def sweep(self, pred) -> list:
        """Remove and return every request matching ``pred``
        (deadline eviction)."""
        removed: list = []
        for prio in list(self._classes):
            q = self._classes[prio]
            hits = [r for r in q if pred(r)]
            if not hits:
                continue
            removed.extend(hits)
            keep = deque(r for r in q if not pred(r))
            if keep:
                self._classes[prio] = keep
            else:
                del self._classes[prio]
        return removed

    def rows_below(self, priority: int) -> int:
        """Rows held by classes STRICTLY lower-priority (numerically
        greater) than ``priority`` — what preemption could free."""
        return sum(r.n for prio, q in self._classes.items()
                   if prio > priority for r in q)

    def evict_below(self, priority: int, rows_needed: int) -> list:
        """Preemption: pop the NEWEST requests from the lowest class
        upward (strictly below ``priority``) until ``rows_needed``
        rows are freed; returns the evicted requests.  Newest-first
        within a class: the evicted waited least, so the least sunk
        queue time is thrown away."""
        evicted: list = []
        freed = 0
        for prio in sorted(self._classes, reverse=True):
            if prio <= priority:
                break
            q = self._classes[prio]
            while q and freed < rows_needed:
                req = q.pop()
                evicted.append(req)
                freed += req.n
            if not q:
                del self._classes[prio]
            if freed >= rows_needed:
                break
        return evicted


class Request:
    """One submitted batch of rows riding the queue."""

    __slots__ = ("x", "n", "future", "t_submit", "deadline", "attempts",
                 "tenant", "priority", "retry_budget", "trace")

    def __init__(self, x,
                 deadline_ms: float | None = None,
                 tenant: str | None = None, priority: int = 0,
                 retry_budget: int | None = None) -> None:
        self.x = x
        self.n = int(x.shape[0])
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = (None if deadline_ms is None
                         else self.t_submit + float(deadline_ms) / 1e3)
        self.attempts = 0
        self.tenant = tenant
        self.priority = int(priority)
        #: per-request override of the batcher's retry budget (the
        #: fleet sets this from the tenant's SLO class)
        self.retry_budget = retry_budget
        #: request-scoped trace: minted at submit (or
        #: adopted from the fleet router), rides the request through
        #: queue wait → coalesced dispatch
        self.trace = (_tracing.adopt_pending_trace()
                      or _tracing.new_request_trace(
                          "request", rows=self.n, tenant=tenant or "-"))
        self.trace.phase_begin("queue")

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
        #: optional observe.metrics Gauge tracking pending rows live
        #: (the engine passes its per-engine-labeled child)
        self._queue_gauge = queue_gauge
        #: per-engine label for the breaker/deadline registry series
        #: (None = bare batcher: counters tracked locally only)
        self._obs_id = obs_id
        self._m_state = (_metrics.serving_breaker_state(obs_id)
                         if obs_id else None)
        if self._m_state is not None:
            self._m_state.set(_STATE_CODE[_CLOSED])
            # pool="all": the one-shot batcher is a single queue —
            # the per-pool children (prefill/decode) belong to the
            # disaggregated engine (ROADMAP A12)
            _metrics.serving_queue_age_seconds(
                obs_id, pool="all").set_function(self.oldest_age_s)
        self._pending = PriorityQueue()
        self._rows = 0
        #: rows pending per tenant (per-tenant queue bounds)
        self._tenant_rows: dict[str, int] = {}
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
        #: (callable, future) pairs run_between queued for the scheduler
        self._control: deque = deque()
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

    def tenant_rows(self, tenant: str) -> int:
        """Rows currently pending for one tenant (telemetry)."""
        return self._tenant_rows.get(tenant, 0)

    def oldest_age_s(self) -> float:
        """Age of the oldest pending request across all priority
        classes (0 when idle; telemetry — the breaker's stall-trip
        watches the highest-priority head instead, see
        :meth:`_breaker_tick`)."""
        try:
            oldest = self._pending.oldest_t()
        except RuntimeError:  # classes dict mutated mid-iteration
            return 0.0
        if oldest is None:
            return 0.0
        return max(0.0, time.monotonic() - oldest)

    # -- row accounting (call under _cond) ------------------------------
    def _account_add(self, req: Request) -> None:
        self._rows += req.n
        if req.tenant is not None:
            self._tenant_rows[req.tenant] = \
                self._tenant_rows.get(req.tenant, 0) + req.n
        if self._queue_gauge is not None:
            self._queue_gauge.set(self._rows)

    def _account_remove(self, req: Request) -> None:
        self._rows -= req.n
        if req.tenant is not None:
            left = self._tenant_rows.get(req.tenant, 0) - req.n
            if left > 0:
                self._tenant_rows[req.tenant] = left
            else:
                self._tenant_rows.pop(req.tenant, None)
        if self._queue_gauge is not None:
            self._queue_gauge.set(self._rows)

    # ------------------------------------------------------------------
    # circuit breaker (call under _cond)
    # ------------------------------------------------------------------
    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        self.warning("circuit breaker %s → %s", self._state, state)
        _recorder.record("breaker", engine=self._obs_id or "batcher",
                         src=self._state, to=state)
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
        """Open → half-open after the cooldown; age-trip when the
        HIGHEST-priority pending head exceeds the stall threshold.
        The stall-trip exists to detect a wedged dispatch path: under
        priority scheduling a starved low class ages unboundedly while
        the device is perfectly healthy, so only the head that would
        dispatch next is evidence of a stall — a starved class is
        handled by its own deadlines, bounds and preemption."""
        if self._state == _OPEN \
                and now - self._opened_at >= self.breaker_cooldown:
            self._transition(_HALF_OPEN)
        head = self._pending.peek()
        if (self._state == _CLOSED and self.max_queue_age is not None
                and head is not None
                and now - head.t_submit > self.max_queue_age):
            self._trip(f"next-dispatch request pending "
                       f"{now - head.t_submit:.1f}s "
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
    def submit(self, x,
               deadline_ms: float | None = None, *,
               tenant: str | None = None, priority: int = 0,
               retry_budget: int | None = None,
               tenant_max_rows: int | None = None) -> Future:
        """Enqueue a request; returns the future of its output rows.

        ``priority`` (smaller = more important) selects the priority
        class; ``tenant`` labels the rows for per-tenant bounds
        (``tenant_max_rows`` caps THIS tenant's pending rows);
        ``retry_budget`` overrides the engine default per request.

        Raises :class:`QueueFull` when the bounded queue has no room
        (after preempting strictly lower-priority rows if that frees
        enough), :class:`Overloaded` while the breaker sheds load,
        :class:`DeadlineExceeded` for a non-positive deadline, and
        ``RuntimeError`` after shutdown."""
        req = Request(x, deadline_ms=deadline_ms, tenant=tenant,
                      priority=priority, retry_budget=retry_budget)
        if req.n < 1 or req.n > self.max_batch:
            raise ValueError(
                f"request of {req.n} rows outside 1..{self.max_batch} "
                f"(max_batch) — split it client-side")
        if deadline_ms is not None and deadline_ms <= 0:
            raise DeadlineExceeded(
                f"deadline_ms={deadline_ms} already expired at submit")
        preempted: list[Request] = []
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            self._breaker_tick(time.monotonic())
            if self._state == _OPEN:
                self.shed_total += 1
                if self._obs_id:
                    _metrics.serving_requests(self._obs_id,
                                              "shed").inc()
                req.trace.event("breaker_shed",
                                engine=self._obs_id or "batcher")
                self._finish_trace(req, "shed")
                raise Overloaded(
                    "circuit breaker open — load shed (retry after "
                    f"{self.breaker_cooldown * 1e3:.0f}ms)")
            if tenant_max_rows is not None and tenant is not None \
                    and self.tenant_rows(tenant) + req.n \
                    > int(tenant_max_rows):
                self._finish_trace(req, "shed")
                raise QueueFull(
                    f"tenant '{tenant}' queue bound reached "
                    f"({self.tenant_rows(tenant)} rows pending, "
                    f"limit {tenant_max_rows})")
            if self._rows + req.n > self.max_queue:
                # preemptive admission: shed the NEWEST strictly
                # lower-priority rows when that fully makes room — a
                # flooding class absorbs its own overload instead of
                # bouncing higher-priority traffic
                need = self._rows + req.n - self.max_queue
                if self._pending.rows_below(req.priority) >= need:
                    preempted = self._pending.evict_below(req.priority,
                                                          need)
                    for ev in preempted:
                        self._account_remove(ev)
                        self.shed_total += 1
                        if self._obs_id:
                            _metrics.serving_requests(
                                self._obs_id, "shed").inc()
                else:
                    self._finish_trace(req, "shed")
                    raise QueueFull(
                        f"serving queue full ({self._rows} rows "
                        f"pending, limit {self.max_queue})")
            self._pending.append(req)
            self._account_add(req)
            self._cond.notify_all()
        # fail preempted futures OUTSIDE the lock: done-callbacks (the
        # fleet's per-tenant outcome accounting) must never run under
        # the batcher condition
        for ev in preempted:
            ev.trace.event("preempted",
                           engine=self._obs_id or "batcher")
            self._finish_trace(ev, "shed")
            if not ev.future.done():
                ev.future.set_exception(Overloaded(
                    "preempted by higher-priority traffic while the "
                    "queue was full"))
        return req.future

    def _finish_trace(self, req: Request, outcome: str) -> None:
        if self._obs_id:
            _metrics.trace_requests(self._obs_id, outcome).inc()
        req.trace.finish(outcome)

    def flush(self) -> None:
        """Dispatch whatever is pending without waiting out the
        admission window (tests, graceful drain points)."""
        with self._cond:
            self._flush_now = True
            self._cond.notify_all()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the scheduler after draining everything pending."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def run_between(self, fn):
        """Run ``fn()`` on the scheduler thread between two dispatches
        and return its result (its exception raises here): nothing it
        does can interleave with a dispatch.  Called from the scheduler
        thread itself, or once the batcher is shut down, it runs
        inline."""
        if threading.current_thread() is self._thread:
            return fn()
        future: Future | None = Future()
        with self._cond:
            if self._stop or not self._thread.is_alive():
                future = None
            else:
                self._control.append((fn, future))
                self._cond.notify_all()
        if future is None:
            return fn()
        return future.result()

    def _run_control(self) -> None:
        """Run what :meth:`run_between` queued (outside ``_cond``)."""
        while True:
            with self._cond:
                if not self._control:
                    return
                fn, future = self._control.popleft()
            try:
                future.set_result(fn())
            except BaseException as exc:  # noqa: BLE001 — the caller's
                future.set_exception(exc)

    # ------------------------------------------------------------------
    def _evict_expired(self, now: float) -> None:
        """Fail-fast every pending request whose deadline passed —
        they are removed BEFORE coalescing, so a timed-out request
        never occupies bucket rows.  Call under ``_cond``."""
        if not any(r.deadline is not None for r in self._pending):
            return
        expired = self._pending.sweep(lambda r: r.expired(now))
        for req in expired:
            self._account_remove(req)
            self.expired_total += 1
            if self._obs_id:
                _metrics.serving_requests(self._obs_id,
                                          "expired").inc()
            req.trace.event("deadline_evicted",
                            engine=self._obs_id or "batcher")
            self._finish_trace(req, "expired")
            req.future.set_exception(DeadlineExceeded(
                f"deadline passed after "
                f"{(now - req.t_submit) * 1e3:.0f}ms in queue"))

    def _wait_timeout(self, now: float) -> float:
        """How long the admission wait may sleep: bounded by the
        window remainder, the nearest pending deadline, and a 250 ms
        housekeeping tick (age-trip + eviction responsiveness)."""
        oldest = self._pending.oldest_t()
        remain = (oldest if oldest is not None else now) \
            + self.max_delay - now
        deadlines = [r.deadline for r in self._pending
                     if r.deadline is not None]
        if deadlines:
            remain = min(remain, max(0.0, min(deadlines) - now))
        if self.max_queue_age is not None:
            remain = min(remain, 0.25)
        return remain

    def _loop(self) -> None:
        while True:
            self._run_control()
            with self._cond:
                while not self._pending and not self._stop \
                        and not self._control:
                    self._cond.wait()
                if self._control:
                    continue
                if not self._pending and self._stop:
                    return
                # admission window: sleep until the batch fills, the
                # oldest request's delay budget runs out, or someone
                # forces a flush; expired requests are swept out and
                # the breaker's stall detector runs on each tick
                while not self._stop and not self._flush_now:
                    now = time.monotonic()
                    self._evict_expired(now)
                    self._breaker_tick(now)
                    if not self._pending or self._control:
                        break
                    if self._rows >= self.max_batch:
                        break
                    remain = self._wait_timeout(now)
                    if remain <= 0:
                        break
                    self._cond.wait(timeout=remain)
                if self._control:
                    # between two dispatches; the window resumes from
                    # the oldest request's submit time
                    continue
                self._evict_expired(time.monotonic())
                batch: list[Request] = []
                rows = 0
                while self._pending:
                    # strict priority order: the highest class's FIFO
                    # prefix fills the bucket first; stop at the first
                    # head that does not fit (no head-of-line skip —
                    # per-class ordering holds)
                    nxt = self._pending.peek()
                    if rows + nxt.n > self.max_batch:
                        break
                    req = self._pending.popleft()
                    rows += req.n
                    batch.append(req)
                    self._account_remove(req)
                    req.trace.phase_end("queue",
                                        engine=self._obs_id or "batcher")
                    req.trace.phase_begin("decode")
                self._flush_now = False
                self._cond.notify_all()
            if not batch:  # everything expired / spurious wakeup
                continue
            try:
                with _tracing.TRACER.span("serve_batch", cat="serving",
                                          requests=len(batch),
                                          rows=rows):
                    self._run_batch(batch)
            except Exception as exc:  # noqa: BLE001 - isolate the batch
                self._record_outcome(False)
                self._dispatch_failed(batch, exc)
            else:
                self._record_outcome(True)
                for req in batch:
                    req.trace.phase_end("decode",
                                        engine=self._obs_id or "batcher")
                    self._finish_trace(req, "ok")
                retried = sum(1 for r in batch if r.attempts)
                if retried:
                    _metrics.recoveries("serving_retry").inc(retried)

    def _dispatch_failed(self, batch: list[Request], exc) -> None:
        """Retry-budget accounting: requests with budget left re-enter
        the FRONT of their own priority class (order preserved); the
        rest fail.  A per-request ``retry_budget`` (the fleet's
        per-tenant SLO) overrides the engine default.  During shutdown
        nothing retries — the drain must terminate."""
        retry: list[Request] = []
        now = time.monotonic()
        with self._cond:
            for req in batch:
                budget = (req.retry_budget if req.retry_budget
                          is not None else self.retry_budget)
                if (not self._stop and req.attempts < budget
                        and not req.expired(now)):
                    req.attempts += 1
                    retry.append(req)
            if retry:
                self.retries_total += len(retry)
                if self._obs_id:
                    _metrics.serving_requests(
                        self._obs_id, "retried").inc(len(retry))
                self._pending.requeue_front(retry)
                for req in retry:
                    self._account_add(req)
                    req.trace.event("dispatch_retry",
                                    engine=self._obs_id or "batcher",
                                    attempt=req.attempts)
                    req.trace.phase_begin("queue")
                self._cond.notify_all()
        failed = [r for r in batch if r not in retry]
        if failed:
            self.warning("batch of %d requests failed: %s",
                         len(failed), exc)
        for req in failed:
            self._finish_trace(req, "failed")
            if not req.future.done():
                req.future.set_exception(exc)
