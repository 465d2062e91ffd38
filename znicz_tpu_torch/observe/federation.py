"""Metrics federation: fold child scrapes into gang-level series (copy
of ``znicz_tpu/observe/federation.py``, which imports no JAX).

Every process of a deployment — each elastic-gang worker, each fleet
replica host — owns a process-local
:class:`~znicz_tpu_torch.observe.metrics.MetricsRegistry`, so the
telemetry is N disjoint ``/metrics`` pages that nothing aggregates.
The :class:`Federator` is the aggregation half: a supervisor or a
maintenance loop registers its children as sources —

- ``add_http(url, process)`` — a worker's live ``/metrics`` endpoint
  (the ``WebStatusServer`` path; parsed with a small text-format
  reader, no new dependency);
- ``add_registry(process, ...)`` — an in-process registry merge (fleet
  replica groups live in the parent process: their series are
  re-labeled, not re-scraped);
- ``add_heartbeats(directory, n)`` — the elastic heartbeat channel
  (per-member step and staleness with no HTTP server on the workers);

and every :meth:`Federator.scrape` folds them into the canonical
``znicz_fed_*`` families with ``gang``/``process``/``pool`` labels, so
one scrape of the folding process answers "which host is slow, which
pool is backed up".  Staleness is first-class: each source carries a
live ``znicz_fed_scrape_age_seconds`` callback gauge, so a child whose
exporter died shows up as age, never as silently frozen numbers.
``/readyz`` folds :func:`status` (report-only unless
``engine.ready_max_fed_age_s`` is set).

Gated on ``root.common.engine.telemetry`` like the rest of the observe
layer; a scrape is O(children), runs on the caller's maintenance
cadence, and never raises into it.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request

from znicz_tpu_torch.observe import metrics as _metrics

__all__ = ["Federator", "FEDERATORS", "status"]

#: every live federator (for /readyz folding and the status page)
FEDERATORS: list = []
_FEDERATORS_LOCK = threading.Lock()

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')

#: the child families a fold extracts (everything else in a child
#: scrape stays child-local — federation is a summary, not a mirror)
_QUEUE_AGE = "znicz_serving_queue_age_seconds"
_REQUESTS = "znicz_serving_requests_total"
_LAST_STEP = "znicz_last_step_timestamp_seconds"


def parse_prometheus(text: str) -> list[tuple[str, dict, float]]:
    """Parse text exposition 0.0.4 into ``(name, labels, value)``
    samples (comment/type lines skipped, unparseable values
    dropped)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_val = m.groups()
        try:
            value = float(raw_val.replace("+Inf", "inf"))
        except ValueError:
            continue
        labels = {k: v for k, v in _LABEL_RE.findall(raw_labels or "")}
        out.append((name, labels, value))
    return out


def _fold_samples(gang: str, process: str,
                  samples: list[tuple[str, dict, float]]) -> set:
    """Common fold: child serving samples → fed gauges; returns the
    ``(process, pool)`` children touched."""
    children: set = set()
    age_by_pool: dict[str, float] = {}
    req_by_event: dict[str, float] = {}
    last_step = None
    for name, labels, value in samples:
        if name == _QUEUE_AGE:
            pool = labels.get("pool", "all")
            age_by_pool[pool] = max(age_by_pool.get(pool, 0.0), value)
        elif name == _REQUESTS:
            event = labels.get("event", "?")
            req_by_event[event] = req_by_event.get(event, 0.0) + value
        elif name == _LAST_STEP:
            last_step = max(last_step or 0.0, value)
    for pool, age in age_by_pool.items():
        _metrics.fed_queue_age_seconds(gang, process, pool).set(age)
        children.add((process, pool))
    for event, total in req_by_event.items():
        _metrics.fed_requests(gang, process, event).set(total)
        children.add((process, "-"))
    if last_step is not None:
        _metrics.fed_step(gang, process).set(last_step)
        children.add((process, "-"))
    return children


class Federator:
    """One gang's metrics folder; sources registered once, folded on
    every :meth:`scrape` (the owner's maintenance cadence)."""

    def __init__(self, gang: str) -> None:
        self.gang = str(gang)
        self._sources: list[dict] = []
        self._lock = threading.Lock()
        self._last_children: set = set()
        _metrics.fed_sources(self.gang).set(0)
        with _FEDERATORS_LOCK:
            FEDERATORS.append(self)

    # ------------------------------------------------------------------
    # source registration
    # ------------------------------------------------------------------
    def _add(self, name: str, fold) -> None:
        src = {"name": name, "fold": fold, "last_ok": None,
               "errors": 0}
        # live staleness gauge: reads the fold clock, not a copy
        _metrics.fed_scrape_age_seconds(self.gang, name).set_function(
            lambda s=src: (float("inf") if s["last_ok"] is None
                           else time.monotonic() - s["last_ok"]))
        with self._lock:
            self._sources.append(src)
        _metrics.fed_sources(self.gang).set(len(self._sources))

    def add_http(self, url: str, process: str,
                 timeout_s: float = 2.0) -> None:
        """A child's live ``/metrics`` endpoint."""
        def fold():
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                text = resp.read().decode("utf-8", "replace")
            return _fold_samples(self.gang, process,
                                 parse_prometheus(text))
        self._add(f"http:{process}", fold)

    def add_registry(self, process: str, registry=None,
                     pool_of=None) -> None:
        """In-process child-registry merge: re-label this process's
        (or ``registry``'s) serving families under the gang.
        ``pool_of(engine_label) -> pool`` overrides the pool a child
        series folds into (disagg pools share one process registry —
        the engine label is the only thing that tells them apart):
        return ``None`` to skip a series that is not ours, ``""`` to
        keep the series' own ``pool`` label (disagg queue-age series
        already carry one)."""
        reg = registry if registry is not None else _metrics.REGISTRY

        def fold():
            samples = []
            for fam_name in (_QUEUE_AGE, _REQUESTS, _LAST_STEP):
                fam = reg.get(fam_name)
                if fam is None:
                    continue
                for key, child in fam.items():
                    labels = dict(zip(fam.labelnames, key))
                    if pool_of is not None and "engine" in labels:
                        pool = pool_of(labels["engine"])
                        if pool is None:
                            continue  # not one of ours
                        if pool:  # "" keeps the series' own pool
                            labels = {**labels, "pool": pool}
                    samples.append((fam_name, labels,
                                    float(child.value)))
            return _fold_samples(self.gang, process, samples)
        self._add(f"registry:{process}", fold)

    def add_heartbeats(self, directory: str, n_processes: int) -> None:
        """The elastic heartbeat channel: per-member step + staleness
        without any worker-side HTTP."""
        def fold():
            children: set = set()
            now = time.time()
            for i in range(int(n_processes)):
                path = os.path.join(directory, f"hb_{i:04d}.json")
                try:
                    with open(path) as fh:
                        hb = json.load(fh)
                except (OSError, ValueError):
                    continue
                process = f"p{int(hb.get('process', i))}"
                age = max(0.0, now - float(hb.get("time", 0.0)))
                _metrics.fed_heartbeat_age_seconds(
                    self.gang, process).set(age)
                _metrics.fed_step(self.gang, process).set(
                    int(hb.get("step", 0)))
                children.add((process, "-"))
            return children
        self._add("heartbeats", fold)

    # ------------------------------------------------------------------
    # folding
    # ------------------------------------------------------------------
    def scrape(self) -> dict:
        """Fold every source once; returns a summary dict.  A failing
        source only ages (its staleness gauge keeps climbing) — the
        fold never raises into the caller's maintenance thread."""
        if not _metrics.enabled():
            return {"gang": self.gang, "sources": 0, "children": 0}
        with self._lock:
            sources = list(self._sources)
        children: set = set()
        ok = 0
        for src in sources:
            try:
                children |= src["fold"]() or set()
                src["last_ok"] = time.monotonic()
                ok += 1
            except Exception:  # noqa: BLE001 — a dead child must not kill the fold
                src["errors"] += 1
        self._last_children = children
        return {"gang": self.gang, "sources": len(sources),
                "sources_ok": ok, "children": len(children)}

    # ------------------------------------------------------------------
    def max_age_s(self) -> float:
        """Staleness of the WORST source (inf when a source has never
        folded) — what /readyz bounds."""
        with self._lock:
            sources = list(self._sources)
        if not sources:
            return 0.0
        now = time.monotonic()
        return max((float("inf") if s["last_ok"] is None
                    else now - s["last_ok"]) for s in sources)

    def status(self) -> dict:
        with self._lock:
            sources = list(self._sources)
        return {
            "gang": self.gang,
            "sources": [{"name": s["name"], "errors": s["errors"],
                         "age_s": (None if s["last_ok"] is None else
                                   round(time.monotonic()
                                         - s["last_ok"], 3))}
                        for s in sources],
            "children": sorted("/".join(c) for c in
                               self._last_children),
        }

    def close(self) -> None:
        with _FEDERATORS_LOCK:
            if self in FEDERATORS:
                FEDERATORS.remove(self)


def status() -> list[dict]:
    """Every live federator's view (the /readyz fold input)."""
    with _FEDERATORS_LOCK:
        feds = list(FEDERATORS)
    return [f.status() for f in feds]


def max_age_s() -> float:
    """Worst staleness across every live federator (0.0 when none —
    a process with no federation has nothing to bound)."""
    with _FEDERATORS_LOCK:
        feds = list(FEDERATORS)
    if not feds:
        return 0.0
    return max(f.max_age_s() for f in feds)
