"""Host-side spans over the control plane and request-scoped traces
(port of ``znicz_tpu/observe/tracing.py``).

:data:`TRACER` records completed host spans (unit fires, workflow runs,
region captures and chunks, serving dispatches) into a bounded ring and
gives them as Chrome-trace JSON (:meth:`SpanTracer.to_chrome_trace`,
:meth:`SpanTracer.export`).  While a
``torch.profiler`` window is open, a span also opens a
``torch.profiler.record_function`` of the same name, so the profiler's
trace shows each unit's name above the kernels it queued, as
``jax.named_scope`` does in the reference.  With no profiler open the
span skips it: nobody would see it.

A :class:`RequestTrace` is minted at ``submit()`` and rides the
request object through the batcher's queue and the dispatch, each phase
a complete span under the request's root span (``trace_id``,
``span_id``, ``parent_span_id`` in its ``args``).
:func:`profile_window` opens a ``torch.profiler`` window (in place of
the reference's ``jax.profiler`` trace) around any region and writes
the window's host spans beside its trace.

Recording is gated on :func:`znicz_tpu_torch.observe.metrics.enabled`
(``root.common.engine.telemetry``); a disabled tracer costs one lookup
a span, and a request gets :data:`NULL_TRACE`.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager

import torch

from znicz_tpu_torch.observe import metrics as _metrics

#: trace time zero (module import); spans report microseconds since
_EPOCH = time.perf_counter()


def now_us() -> float:
    """Microseconds since the tracer's epoch (the trace's ``ts``)."""
    return (time.perf_counter() - _EPOCH) * 1e6


class _NullSpan:
    """The span handed out when telemetry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_rf", "_t0",
                 "_depth")

    def __init__(self, tracer, name, cat, args) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self._name)
        self._rf = (torch.profiler.record_function(self._name)
                    if torch.autograd.profiler._is_profiler_enabled
                    else None)
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = now_us()
        return self

    def __exit__(self, *exc):
        t1 = now_us()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._tracer._stack().pop()
        self._tracer._append({
            "ph": "X", "name": self._name, "cat": self._cat,
            "pid": self._tracer._pid, "tid": threading.get_native_id(),
            "ts": self._t0, "dur": t1 - self._t0,
            "args": {**self._args, "depth": self._depth}})
        return False


class SpanTracer:
    """Bounded ring of completed host spans."""

    def __init__(self, max_events: int = 65536) -> None:
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._seq = 0
        self._pid = os.getpid()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, event: dict) -> None:
        with self._lock:
            self._seq += 1
            event["_seq"] = self._seq
            self._events.append(event)

    def mark(self) -> int:
        """A position marker; pass it as ``since`` to
        :meth:`to_chrome_trace` or :meth:`export` to keep only later
        events."""
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def span(self, name: str, cat: str = "host", **args):
        """Record a span around the with-body (nesting tracked per
        thread in the event's ``depth``)."""
        if not _metrics.enabled():
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def complete(self, name: str, t0_us: float, t1_us: float,
                 cat: str = "host", **args) -> None:
        """Record a span from explicit timestamps (one known only at
        its end)."""
        if not _metrics.enabled():
            return
        self._append({
            "ph": "X", "name": name, "cat": cat,
            "pid": self._pid, "tid": threading.get_native_id(),
            "ts": t0_us, "dur": max(0.0, t1_us - t0_us),
            "args": {**args, "depth": 0}})

    def instant(self, name: str, cat: str = "host", **args) -> None:
        if not _metrics.enabled():
            return
        self._append({
            "ph": "i", "s": "t", "name": name, "cat": cat,
            "pid": self._pid, "tid": threading.get_native_id(),
            "ts": now_us(), "args": dict(args)})

    def events(self, since: int = 0) -> list[dict]:
        with self._lock:
            return [{k: v for k, v in ev.items() if k != "_seq"}
                    for ev in self._events if ev["_seq"] > since]

    def to_chrome_trace(self, since: int = 0) -> dict:
        """The Chrome-trace JSON object (``traceEvents``)."""
        head = [{"ph": "M", "name": "process_name", "pid": self._pid,
                 "tid": 0, "args": {"name": "znicz_tpu_torch host spans"}}]
        return {"traceEvents": head + self.events(since),
                "displayTimeUnit": "ms"}

    def export(self, path: str, since: int = 0) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(since=since), fh)
        return path


#: the process-global tracer every instrumentation site records on
TRACER = SpanTracer()


# ----------------------------------------------------------------------
# request-scoped trace context
# ----------------------------------------------------------------------
#: process-unique trace-id sequence (pid-prefixed, so merged traces of
#: several processes never collide)
_TRACE_SEQ = itertools.count(1)


class RequestTrace:
    """Trace context minted at ``submit()`` that rides the request
    object (not a thread-local) through every hop: the batcher's queue,
    the coalesced dispatch.

    Phases are begun and ended from whatever thread holds the request;
    each closed phase lands in :data:`TRACER` as a ``cat="request"``
    complete span under the request's root span.  :meth:`phase_end`
    returns the phase's duration in seconds."""

    __slots__ = ("trace_id", "name", "args", "t0_us", "_phase_t0",
                 "_span_seq", "phases", "events", "_finished")

    def __init__(self, name: str = "request", **args) -> None:
        self.trace_id = f"{os.getpid():x}-{next(_TRACE_SEQ):06x}"
        self.name = name
        self.args = dict(args)
        self.t0_us = now_us()
        self._phase_t0: dict[str, float] = {}
        #: the root span is 1; child spans and events count up from 2
        self._span_seq = itertools.count(2)
        self.phases: dict[str, float] = {}
        self.events: list[str] = []
        self._finished = False

    def phase_begin(self, phase: str) -> None:
        """Open ``phase`` (idempotent: a retry re-entering a phase keeps
        the first begin, so retried work is charged to the phase that
        absorbed it)."""
        self._phase_t0.setdefault(phase, now_us())

    def phase_end(self, phase: str, **args) -> float:
        """Close ``phase`` and record it as a child span; its duration
        in seconds (0.0 when it never began)."""
        t0 = self._phase_t0.pop(phase, None)
        if t0 is None:
            return 0.0
        t1 = now_us()
        dur_s = (t1 - t0) / 1e6
        self.phases[phase] = self.phases.get(phase, 0.0) + dur_s
        TRACER.complete(f"req.{phase}", t0, t1, cat="request",
                        trace_id=self.trace_id,
                        span_id=next(self._span_seq),
                        parent_span_id=1, phase=phase, **args)
        return dur_s

    def event(self, name: str, **args) -> None:
        """An instant under the request's root span (a shed, a deadline
        eviction, a retry)."""
        self.events.append(name)
        TRACER.instant(f"req.{name}", cat="request",
                       trace_id=self.trace_id,
                       span_id=next(self._span_seq),
                       parent_span_id=1, **args)

    def finish(self, outcome: str = "ok", **args) -> None:
        """Close the root span (idempotent: the first outcome wins)."""
        if self._finished:
            return
        self._finished = True
        for phase in list(self._phase_t0):  # close any dangling phase
            self.phase_end(phase)
        TRACER.complete(self.name, self.t0_us, now_us(), cat="request",
                        trace_id=self.trace_id, span_id=1,
                        parent_span_id=0, outcome=outcome,
                        **{**self.args, **args})


class _NullTrace:
    """The no-op trace every call site holds when telemetry is off."""

    __slots__ = ()
    trace_id = "-"
    phases: dict = {}
    events: list = []

    def phase_begin(self, phase: str) -> None:
        pass

    def phase_end(self, phase: str, **args) -> float:
        return 0.0

    def event(self, name: str, **args) -> None:
        pass

    def finish(self, outcome: str = "ok", **args) -> None:
        pass


NULL_TRACE = _NullTrace()


def new_request_trace(name: str = "request", **args):
    """A request trace (:data:`NULL_TRACE` when telemetry is off, so
    call sites never branch)."""
    if not _metrics.enabled():
        return NULL_TRACE
    return RequestTrace(name, **args)


#: adoption channel: a caller mints the trace, parks it here, and the
#: batcher's same-thread ``submit()`` adopts it instead of minting one
_PENDING = threading.local()


def set_pending_trace(trace) -> None:
    _PENDING.trace = trace


def adopt_pending_trace():
    """Pop the thread's parked trace (None when nothing was parked)."""
    trace = getattr(_PENDING, "trace", None)
    _PENDING.trace = None
    return trace


@contextmanager
def profile_window(outdir: str, n_steps: int | None = None,
                   device: bool = True, tracer: SpanTracer | None = None):
    """A ``torch.profiler`` window plus the window's host spans around
    the with-body.

    ``outdir`` receives the profiler's Chrome trace
    (``device.trace.json``, the card's kernels beside the host's
    operations) and ``host_spans.trace.json`` (the host spans recorded
    during the window).  ``n_steps`` is recorded on the window's span
    for per-step arithmetic afterwards; ``device=False`` skips the
    profiler (host spans only)."""
    if tracer is None:  # NOT `or`: an empty SpanTracer is falsy
        tracer = TRACER
    os.makedirs(outdir, exist_ok=True)
    prof = None
    if device:
        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        except Exception as exc:  # noqa: BLE001 — a window must not kill the run
            prof = None
            logging.getLogger("znicz_tpu_torch.observe").warning(
                "profile_window: device trace unavailable (%s) — "
                "recording host spans only", exc)
    mark = tracer.mark()
    try:
        with tracer.span("profile_window", cat="profile",
                         n_steps=n_steps or 0):
            yield outdir
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(
                    os.path.join(outdir, "device.trace.json"))
            except Exception:  # noqa: BLE001 — already stopped elsewhere
                pass
        tracer.export(os.path.join(outdir, "host_spans.trace.json"),
                      since=mark)
