"""Process-local metrics registry: counters, gauges, histograms (port of
``znicz_tpu/observe/metrics.py``).

A thread-safe registry of named metric families in the Prometheus data
model — counters, gauges and fixed-bucket histograms, each optionally
split by a small fixed set of labels — with the Prometheus text
(0.0.4) exposition.  The registry core is a copy of the reference's; of its
canonical series the port carries the ``znicz_serving_*`` family
the serving engine and its batcher write, the snapshotter's
``znicz_snapshot_*`` pair, ``recoveries``, and the runtime core's
series: workflow runs, per-unit run time, region steps, the
host↔device bytes of the ``Vector`` protocol and CUDA-graph captures
(the counterpart of the reference's ``xla_compiles("region:…")``),
the series of fault injection, hot swap, the SDC shadow audit,
request traces and the flight recorder, and decode's: time to first
token and per token, token counts, live slots, the KV page pool, the
prefix cache, speculative verdicts, the per-phase p99 gauges and the
swap drain's admission pause.
The hot-path series (unit times, transfer bytes) are gated on
:func:`enabled`; the rest are always counted.  The
port's registry is its own: a process that imports both packages
keeps two.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import OrderedDict
from typing import Callable, Iterable


#: default histogram bounds (seconds): log-ish ladder from 0.1 ms to
#: 30 s — covers unit fires, serve latencies and snapshot writes
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt(value: float) -> str:
    """Prometheus sample-value formatting: integral floats print as
    integers, +Inf spelled the Prometheus way."""
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class Counter:
    """Monotone accumulator child."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, "
                             f"got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Set-to-current child.  ``set_function`` turns it into a
    callback gauge read at collect time (live queue depths)."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock
        self._value = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a dead callback reads 0
                return 0.0
        return self._value


class Histogram:
    """Fixed-bucket distribution child with Prometheus ``le``
    semantics (cumulative counts of observations <= bound)."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, lock: threading.RLock,
                 bounds: tuple[float, ...]) -> None:
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

class MetricFamily:
    """One named metric + its labeled children."""

    KINDS = ("counter", "gauge", "histogram")
    _CHILD = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: tuple[str, ...],
                 lock: threading.RLock,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        if kind not in self.KINDS:
            raise ValueError(f"unknown metric kind '{kind}'")
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets))
        self._lock = lock
        self._children: "OrderedDict[tuple, object]" = OrderedDict()

    def labels(self, **labelvalues):
        """The child for this label combination, created on first
        use.  Label names must match the family declaration exactly."""
        if tuple(sorted(labelvalues)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric '{self.name}' declares labels "
                f"{self.labelnames}, got {tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "histogram":
                    child = Histogram(self._lock, self.buckets)
                else:
                    child = self._CHILD[self.kind](self._lock)
                self._children[key] = child
            return child

    def items(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Thread-safe, process-local registry of metric families."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: "OrderedDict[str, MetricFamily]" = OrderedDict()

    # ------------------------------------------------------------------
    # declaration (idempotent: re-declaring the same family returns it)
    # ------------------------------------------------------------------
    def _declare(self, name: str, kind: str, help_: str,
                 labels: Iterable[str],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS
                 ) -> MetricFamily:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labels:
                    raise ValueError(
                        f"metric '{name}' already registered as "
                        f"{fam.kind}{fam.labelnames}, cannot re-declare "
                        f"as {kind}{labels}")
                return fam
            fam = MetricFamily(name, kind, help_, labels, self._lock,
                               buckets=buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._declare(name, "counter", help_, labels)

    def gauge(self, name: str, help_: str = "",
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._declare(name, "gauge", help_, labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Iterable[str] = (),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> MetricFamily:
        return self._declare(name, "histogram", help_, labels,
                             buckets=buckets)

    # ------------------------------------------------------------------
    # exposition
    # ------------------------------------------------------------------
    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4."""
        lines: list[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.items():
                pairs = [f'{n}="{_escape_label(v)}"'
                         for n, v in zip(fam.labelnames, key)]
                base = ",".join(pairs)
                if fam.kind == "histogram":
                    cum = 0
                    for bound, n in zip(fam.buckets + (math.inf,),
                                        child.counts):
                        cum += n
                        le = ([f'le="{_fmt(bound)}"'] if not base
                              else pairs + [f'le="{_fmt(bound)}"'])
                        lines.append(
                            f"{fam.name}_bucket{{{','.join(le)}}} {cum}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(
                        f"{fam.name}_sum{suffix} {_fmt(child.sum)}")
                    lines.append(
                        f"{fam.name}_count{suffix} {child.count}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(
                        f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


#: the process-global registry every framework series registers on
REGISTRY = MetricsRegistry()


# ----------------------------------------------------------------------
# canonical serving series — single home for the names so the engine,
# the batcher and the tests agree on them by construction
# ----------------------------------------------------------------------
def serving_requests(engine: str, event: str) -> Counter:
    return REGISTRY.counter(
        "znicz_serving_requests_total",
        "Serving requests by lifecycle event "
        "(submitted/served/rejected)",
        labels=("engine", "event")).labels(engine=engine, event=event)


def serving_latency_seconds(engine: str) -> Histogram:
    return REGISTRY.histogram(
        "znicz_serving_latency_seconds",
        "Serving enqueue->reply latency",
        labels=("engine",)).labels(engine=engine)


def serving_queue_rows(engine: str) -> Gauge:
    return REGISTRY.gauge(
        "znicz_serving_queue_rows",
        "Rows pending in the continuous batcher's bounded queue",
        labels=("engine",)).labels(engine=engine)


def serving_bucket_batches(engine: str, bucket: int) -> Counter:
    return REGISTRY.counter(
        "znicz_serving_bucket_batches_total",
        "Coalesced batches dispatched per bucket size",
        labels=("engine", "bucket")).labels(engine=engine,
                                            bucket=bucket)


def serving_bucket_rows(engine: str, bucket: int) -> Counter:
    return REGISTRY.counter(
        "znicz_serving_bucket_rows_total",
        "Real (non-padded) rows served per bucket size",
        labels=("engine", "bucket")).labels(engine=engine,
                                            bucket=bucket)


def serving_warmup_seconds(engine: str) -> Gauge:
    return REGISTRY.gauge(
        "znicz_serving_warmup_seconds",
        "Wall time spent warming the bucket ladder at start()",
        labels=("engine",)).labels(engine=engine)


def enabled() -> bool:
    """The telemetry gate: ``root.common.engine.telemetry`` (default
    on).  Per-unit spans and times and the transfer byte counts skip
    their work when it is off; rare events (captures, snapshots) are
    always counted."""
    from znicz_tpu_torch.utils.config import root
    return bool(root.common.engine.get("telemetry", True))


def workflow_runs(workflow: str) -> Counter:
    return REGISTRY.counter(
        "znicz_workflow_runs_total", "Workflow.run invocations",
        labels=("workflow",)).labels(workflow=workflow)


def unit_run_seconds(unit: str) -> Histogram:
    """Per-unit ``run()`` wall time (host control plane)."""
    return REGISTRY.histogram(
        "znicz_unit_run_seconds", "Unit.run wall time by unit name",
        labels=("unit",)).labels(unit=unit)


def transfer_bytes(direction: str) -> Counter:
    """Host↔device bytes through the ``Vector`` map/unmap protocol
    (``h2d`` uploads, ``d2h`` fetches)."""
    return REGISTRY.counter(
        "znicz_device_transfer_bytes_total",
        "Vector host<->device transfer bytes by direction",
        labels=("direction",)).labels(direction=direction)


def region_steps(region: str) -> Counter:
    return REGISTRY.counter(
        "znicz_region_steps_total",
        "Region steps run (a chunk counts each of its steps)",
        labels=("region",)).labels(region=region)


def grad_accum_microbatches(workflow: str) -> Gauge:
    """Microbatches accumulated on the device an optimizer step
    (``engine.grad_accum``); 1 means fused batches."""
    return REGISTRY.gauge(
        "znicz_grad_accum_microbatches",
        "Gradient-accumulation microbatches per optimizer step",
        labels=("workflow",)).labels(workflow=workflow)


def graph_captures(region: str) -> Counter:
    """CUDA-graph captures of a region, one per static key: the
    counterpart of the reference's ``xla_compiles("region:<name>")``.
    It stays flat once every key of a run has been seen.  Decode's
    programs count under the reference's sites (``serving-prefill``,
    ``serving-decode``, ``serving-verify``, ``serving-page``)."""
    return REGISTRY.counter(
        "znicz_graph_captures_total",
        "CUDA-graph captures of a region's step, by region",
        labels=("region",)).labels(region=region)


def recoveries(kind: str) -> Counter:
    """Recovery events: the system absorbed a fault and kept going
    (here: ``serving_retry``, a request served after a failed
    dispatch was retried; ``snapshot_write``, training went on after a
    failed snapshot write; ``snapshot_fallback``, a corrupt snapshot
    was replaced by an older good one)."""
    return REGISTRY.counter(
        "znicz_recoveries_total",
        "Faults absorbed without failing the run, by recovery kind",
        labels=("kind",)).labels(kind=kind)


def snapshot_failures(op: str) -> Counter:
    return REGISTRY.counter(
        "znicz_snapshot_failures_total",
        "Snapshot operations that failed and were absorbed "
        "(op=write: training continued on the last good snapshot; "
        "op=load: a corrupt file fell back to an older snapshot)",
        labels=("op",)).labels(op=op)


def snapshot_seconds(op: str) -> Histogram:
    return REGISTRY.histogram(
        "znicz_snapshot_seconds",
        "Snapshot state-tree save/load duration",
        labels=("op",)).labels(op=op)


def serving_breaker_state(engine: str) -> Gauge:
    """0 = closed (healthy), 1 = half-open (probing), 2 = open
    (shedding load with fast Overloaded replies)."""
    return REGISTRY.gauge(
        "znicz_serving_breaker_state",
        "Circuit-breaker state (0 closed, 1 half-open, 2 open)",
        labels=("engine",)).labels(engine=engine)


def serving_breaker_transitions(engine: str, to: str) -> Counter:
    return REGISTRY.counter(
        "znicz_serving_breaker_transitions_total",
        "Circuit-breaker state transitions by target state",
        labels=("engine", "to")).labels(engine=engine, to=to)


def serving_queue_age_seconds(engine: str, pool: str = "all") -> Gauge:
    """Age of the oldest pending request (live callback gauge) — the
    breaker's stall signal.  The one-shot engine is a single queue and
    writes the ``all`` child, the same series the reference scrapes."""
    return REGISTRY.gauge(
        "znicz_serving_queue_age_seconds",
        "Age of the oldest request pending in the serving queue",
        labels=("engine", "pool")).labels(engine=engine, pool=pool)


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


# ----------------------------------------------------------------------
# fault injection, hot swap, the SDC audit, request traces and the
# flight recorder (the reference's series of the same names)
# ----------------------------------------------------------------------
def faults_injected(site: str) -> Counter:
    """Deterministic fault-injection events by named site (one event
    per transient firing; a persistent fault counts once)."""
    return REGISTRY.counter(
        "znicz_faults_injected_total",
        "Injected fault events by site (resilience.faults)",
        labels=("site",)).labels(site=site)


def swaps_total(engine: str, outcome: str) -> Counter:
    """Weight hot-swap verdicts per serving engine (``promoted``,
    ``rejected``, ``rolled_back``)."""
    return REGISTRY.counter(
        "znicz_swaps_total",
        "Weight hot-swap outcomes (promoted/rejected/rolled_back)",
        labels=("engine", "outcome")).labels(engine=engine,
                                             outcome=outcome)


def model_version(engine: str) -> Gauge:
    """The published-model version an engine is serving (0 = the
    bundle it started from)."""
    return REGISTRY.gauge(
        "znicz_model_version",
        "Published model version currently live on the engine",
        labels=("engine",)).labels(engine=engine)


def swap_duration_seconds(engine: str) -> Histogram:
    """Hot-swap duration: staging the candidate on the device, off the
    dispatch path, plus the publish between two dispatches."""
    return REGISTRY.histogram(
        "znicz_swap_duration_seconds",
        "Weight hot-swap duration (stage + drain + atomic flip)",
        labels=("engine",)).labels(engine=engine)


def sdc_detected(kind: str) -> Counter:
    """Confirmed silent-data-corruption detections by detector (here
    ``serving``: the sampled shadow re-score of live replies)."""
    return REGISTRY.counter(
        "znicz_sdc_detected_total",
        "Confirmed SDC detections by detector (vote/audit/serving)",
        labels=("kind",)).labels(kind=kind)


def sdc_suspects(process, device: str) -> Counter:
    """SDC suspicion events by process and serving replica."""
    return REGISTRY.counter(
        "znicz_sdc_suspect_total",
        "SDC suspicion events by process and device/replica",
        labels=("process", "device")).labels(process=process,
                                             device=device)


def trace_requests(engine: str, outcome: str) -> Counter:
    """Request traces closed per engine by outcome (``ok``, ``shed``,
    ``expired``, ``failed``)."""
    return REGISTRY.counter(
        "znicz_trace_requests_total",
        "Request-scoped traces finished, by outcome",
        labels=("engine", "outcome")).labels(engine=engine,
                                             outcome=outcome)


def flightrecord_events(kind: str) -> Counter:
    """Ops events journaled by the flight recorder, by kind."""
    return REGISTRY.counter(
        "znicz_flightrecord_events_total",
        "Flight-recorder events journaled, by kind",
        labels=("kind",)).labels(kind=kind)


def flightrecord_dropped() -> Counter:
    """Flight-recorder events dropped because the journal write stalled
    or failed: telemetry degrades to counting here and never blocks a
    dispatch or a swap."""
    return REGISTRY.counter(
        "znicz_flightrecord_dropped_total",
        "Flight-recorder events dropped on journal write "
        "stall/failure").labels()


# ----------------------------------------------------------------------
# decode (serving.decode): the reference's series of the same names
# ----------------------------------------------------------------------
def serving_ttft_seconds(engine: str) -> Histogram:
    """Time to first token: submit → the first generated token (queue
    wait, prefill and the first sample), from admission-eligible time."""
    return REGISTRY.histogram(
        "znicz_serving_ttft_seconds",
        "Decode time-to-first-token (submit -> first token)",
        labels=("engine",)).labels(engine=engine)


def serving_token_seconds(engine: str) -> Histogram:
    """Per-token decode latency: one observation a generated token after
    the first (the cadence a streaming client sees)."""
    return REGISTRY.histogram(
        "znicz_serving_token_seconds",
        "Decode per-token latency (inter-token cadence after the "
        "first token)", labels=("engine",)).labels(engine=engine)


def serving_tokens(engine: str, kind: str) -> Counter:
    """Tokens by kind: ``prompt`` (prefilled positions) and
    ``generated`` (sampled tokens)."""
    return REGISTRY.counter(
        "znicz_serving_tokens_total",
        "Decode tokens by kind (prompt=prefilled, generated=sampled)",
        labels=("engine", "kind")).labels(engine=engine, kind=kind)


def serving_decode_slots(engine: str) -> Gauge:
    """Sequences mid-generation, each holding a KV-cache slot."""
    return REGISTRY.gauge(
        "znicz_serving_decode_slots",
        "Sequences currently occupying KV-cache decode slots",
        labels=("engine",)).labels(engine=engine)


def kv_pages_total(engine: str) -> Gauge:
    """Pages of the paged KV pool (fixed at construction)."""
    return REGISTRY.gauge(
        "znicz_kv_pages_total",
        "KV-cache pages in the paged decode pool",
        labels=("engine",)).labels(engine=engine)


def kv_pages_used(engine: str) -> Gauge:
    """Pages held by live sequences and the prefix cache (a live
    callback gauge)."""
    return REGISTRY.gauge(
        "znicz_kv_pages_used",
        "KV-cache pages held by live sequences + the prefix cache",
        labels=("engine",)).labels(engine=engine)


def kv_bytes_per_lane(engine: str) -> Gauge:
    """KV-cache bytes over ``max_slots`` (int8 pages' scale pools
    included): what bounds decode concurrency per byte."""
    return REGISTRY.gauge(
        "znicz_kv_bytes_per_lane",
        "KV-cache bytes reserved per decode lane",
        labels=("engine",)).labels(engine=engine)


def kv_page_migrations(engine: str, direction: str) -> Counter:
    """KV pages moved between tiers or pools by direction (``spill``,
    ``restore``, ``handoff``).  The port has neither a second tier nor a
    pool handoff yet (ROADMAP A12), so nothing writes it."""
    return REGISTRY.counter(
        "znicz_kv_page_migrations_total",
        "KV pages moved between cache tiers / serving pools",
        labels=("engine", "direction")).labels(engine=engine,
                                               direction=direction)


def prefix_cache_events(engine: str, event: str) -> Counter:
    """Prefix-sharing admissions: ``hit``, ``miss``, and ``evicted``
    (a cached block released under pool pressure)."""
    return REGISTRY.counter(
        "znicz_prefix_cache_total",
        "Prefix-cache admission events (hit/miss/evicted)",
        labels=("engine", "event")).labels(engine=engine, event=event)


def prefix_tokens(engine: str, kind: str) -> Counter:
    """Prompt tokens by prefix-cache outcome: ``shared`` (their K/V
    pages reused) and ``computed`` (prefilled)."""
    return REGISTRY.counter(
        "znicz_prefix_tokens_total",
        "Prompt tokens by prefix-cache outcome (shared/computed)",
        labels=("engine", "kind")).labels(engine=engine, kind=kind)


def spec_tokens(engine: str, verdict: str) -> Counter:
    """Drafted tokens by the verifier's verdict (``accepted``,
    ``rejected``)."""
    return REGISTRY.counter(
        "znicz_spec_tokens_total",
        "Drafted tokens by verification verdict (accepted/rejected)",
        labels=("engine", "verdict")).labels(engine=engine,
                                             verdict=verdict)


def swap_pause_seconds(engine: str) -> Counter:
    """Wall time decode admission was paused by swap drains: what the
    TTFT clocks (admission-eligible time) leave out."""
    return REGISTRY.counter(
        "znicz_swap_pause_seconds_total",
        "Decode admission pause time accumulated by swap drains",
        labels=("engine",)).labels(engine=engine)


def window_p99(win, n0: int = 0) -> float:
    """p99 of a latency window's samples after the first ``n0``."""
    return _percentile(sorted(list(win)[n0:]), 99.0)


def phase_p99_seconds(engine: str, phase: str) -> Gauge:
    """Exact windowed p99 of one serving phase (``queue``, ``prefill``,
    ``handoff``, ``decode``, ``ttft``, ``token``), a live callback
    gauge over the engine's bounded window."""
    return REGISTRY.gauge(
        "znicz_phase_p99_seconds",
        "Exact windowed p99 latency per serving phase",
        labels=("engine", "phase")).labels(engine=engine, phase=phase)
