"""Host-side spans over the control plane (the part of
``znicz_tpu/observe/tracing.py`` the runtime core uses).

:data:`TRACER` records completed host spans (unit fires, workflow runs,
region captures and chunks) into a bounded ring and gives them as
Chrome-trace JSON (:meth:`SpanTracer.to_chrome_trace`).  While a
``torch.profiler`` window is open, a span also opens a
``torch.profiler.record_function`` of the same name, so the profiler's
trace shows each unit's name above the kernels it queued, as
``jax.named_scope`` does in the reference.  With no profiler open the
span skips it: nobody would see it.

Recording is gated on :func:`znicz_tpu_torch.observe.metrics.enabled`
(``root.common.engine.telemetry``); a disabled tracer costs one lookup
a span.  Request tracing and the flight recorder are not ported here.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

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

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def span(self, name: str, cat: str = "host", **args):
        """Record a span around the with-body (nesting tracked per
        thread in the event's ``depth``)."""
        if not _metrics.enabled():
            return _NULL_SPAN
        return _Span(self, name, cat, args)

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


#: the process-global tracer every instrumentation site records on
TRACER = SpanTracer()
