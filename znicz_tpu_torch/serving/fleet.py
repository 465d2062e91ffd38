"""FleetEngine: many models in one process, per-tenant SLOs, and the
autoscalers of its replica groups and of the disaggregated engine's
pools (port of ``znicz_tpu/serving/fleet.py``).

N exported bundles (one-shot scorers and decode LMs mixed) resident in
one process on the card, requests routed by model id and version,
scheduled under explicit per-tenant SLOs, and isolated: a flooded
tenant sheds inside its own class.

The layers, bottom up:

- **routing** — each model holds versions with weighted A/B traffic
  (:meth:`FleetEngine.set_traffic`; a smooth weighted round robin, so
  the fractions are exact over any window), each version a
  :class:`ReplicaGroup` of engines picked round robin, skipping a
  replica whose breaker is open or that the SDC audit marked suspect;
- **priority admission** — every tenant has a :class:`TenantClass`
  (priority, token-bucket rate, default deadline, retry budget,
  queue-row bound).  The priority rides into the engines' batchers
  (:class:`~znicz_tpu_torch.serving.batcher.PriorityQueue`): pending
  work dispatches in strict priority order, and a full queue preempts
  the newest lower-priority rows instead of bouncing higher-priority
  traffic;
- **per-tenant degradation** — token-bucket shedding, a per-tenant
  breaker (sustained shedding or failure opens it; while open that
  tenant alone gets an instant :class:`Overloaded`; cooldown, then
  half-open, and one probe decides), deadlines and retry budgets;
- **a shared memory budget** — every one-shot model's bucket ladder
  charges one :class:`SharedLadderBudget`; pressure evicts the
  lowest-priority model's least recently used bucket first
  (``znicz_fleet_ladder_evictions_total``).  On the card an evicted
  bucket's CUDA graph is released, and the next request for it
  captures it again (``znicz_graph_captures_total{serving:*}``);
- **autoscaling** — :class:`FleetAutoscaler` grows and shrinks each
  group from the queue-age and bucket-occupancy series and repairs a
  group after a replica loss.  One-shot replicas share their version's
  :class:`~znicz_tpu_torch.export.ExportedModel`, its ladder of graphs
  and one copy of its weights, so scale-up and repair capture nothing.

The fleet's device is :meth:`ServingEngine.resolve_device
<znicz_tpu_torch.serving.engine.ServingEngine.resolve_device>` (the
card, an error without one; the first card when several are visible),
unless the caller passes ``device`` (``"cpu"`` on a machine without a
GPU).  Decode replicas each build their engine on the same device.

Drill sites (:mod:`znicz_tpu_torch.resilience.faults`):
``fleet.tenant_flood`` (a burst on one tenant at :meth:`FleetEngine.
tick`) and ``fleet.replica_loss`` (a live replica killed: routing
steers around it and the autoscaler repairs the group).
``fleet.model_corrupt`` fires in the model registry
(:meth:`znicz_tpu_torch.forge.ForgeRegistry.fetch`).

Telemetry: ``znicz_fleet_requests_total{tenant,event}``,
``znicz_fleet_latency_seconds`` and ``znicz_fleet_latency_p99_seconds``,
``znicz_fleet_breaker_state{tenant}``, ``znicz_fleet_models``,
``znicz_fleet_replicas``, ``znicz_fleet_scale_events_total``,
``znicz_fleet_traffic_weight``, ``znicz_fleet_tenant_tokens`` and
``znicz_fleet_ladder_evictions_total``; :meth:`FleetEngine.tick` folds
the replicas' serving series into ``znicz_fed_*`` under their
``model@version`` pool.

Locking: the fleet lock guards the tenant and model tables only and is
never held across a call into an engine, whose scheduler threads run
the futures' callbacks back into the fleet.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future

import numpy as np

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import recorder as _recorder
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.serving.batcher import (_CLOSED, _HALF_OPEN, _OPEN,
                                       _STATE_CODE, DeadlineExceeded,
                                       Overloaded, QueueFull,
                                       TokenBucketLimiter)
from znicz_tpu_torch.utils.logger import Logger

__all__ = ["FleetEngine", "TenantClass", "ReplicaGroup",
           "SharedLadderBudget", "FleetAutoscaler"]

#: distinguishes same-process fleets in the registry's labels
_FLEET_SEQ = itertools.count()


class TenantClass:
    """One tenant's SLO class.

    ``priority``: 0 is the most important class; dispatch, preemption
    and KV-slot admission all order by it.  ``rate``/``burst``: the
    admission token bucket in rows (one-shot) / prompts (decode) per
    second — ``None`` disables rate limiting.  ``deadline_ms`` /
    ``retry_budget``: per-tenant defaults threaded into every
    dispatch.  ``max_queue_rows`` caps this tenant's share of any one
    engine's queue."""

    __slots__ = ("name", "priority", "rate", "burst", "deadline_ms",
                 "retry_budget", "max_queue_rows")

    def __init__(self, name: str, *, priority: int = 1,
                 rate: float | None = None, burst: float | None = None,
                 deadline_ms: float | None = None,
                 retry_budget: int | None = None,
                 max_queue_rows: int | None = None) -> None:
        self.name = str(name)
        self.priority = int(priority)
        self.rate = rate
        self.burst = burst
        self.deadline_ms = deadline_ms
        self.retry_budget = retry_budget
        self.max_queue_rows = max_queue_rows


class _TenantState:
    """Live admission state for one tenant on one fleet: token
    bucket, per-tenant circuit breaker, exact latency window, and the
    registry children everything exports through."""

    def __init__(self, fleet_id: str, cls: TenantClass,
                 breaker_failure_rate: float, breaker_window: int,
                 breaker_min_samples: int,
                 breaker_cooldown_ms: float) -> None:
        self.cls = cls
        self.bucket = TokenBucketLimiter(cls.rate, cls.burst)
        self.state = _CLOSED
        self.opened_at = 0.0
        self.probe_inflight = False
        self.failure_rate = float(breaker_failure_rate)
        self.min_samples = int(breaker_min_samples)
        self.cooldown = float(breaker_cooldown_ms) / 1e3
        self.outcomes: deque[bool] = deque(maxlen=int(breaker_window))
        self.latency_win: deque[float] = deque(maxlen=4096)
        self.counts = {"submitted": 0, "served": 0, "shed": 0,
                       "expired": 0, "failed": 0}
        self._m = {event: _metrics.fleet_requests(fleet_id, cls.name,
                                                  event)
                   for event in self.counts}
        self._m_lat = _metrics.fleet_latency_seconds(fleet_id, cls.name)
        self._m_state = _metrics.fleet_breaker_state(fleet_id, cls.name)
        self._m_state.set(_STATE_CODE[_CLOSED])
        _metrics.fleet_latency_p99_seconds(
            fleet_id, cls.name).set_function(self.p99)
        _metrics.fleet_tenant_tokens(fleet_id, cls.name).set_function(
            lambda b=self.bucket: b.level)

    # -- called under the fleet lock ------------------------------------
    def count(self, event: str) -> None:
        self.counts[event] += 1
        self._m[event].inc()

    def observe_latency(self, seconds: float) -> None:
        self.latency_win.append(seconds)
        self._m_lat.observe(seconds)

    def p99(self) -> float:
        win = sorted(self.latency_win)
        if not win:
            return 0.0
        idx = min(len(win) - 1,
                  max(0, int(round(0.99 * (len(win) - 1)))))
        return win[idx]

    def transition(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        if state == _OPEN:
            self.opened_at = time.monotonic()
        self._m_state.set(_STATE_CODE[state])

    def breaker_tick(self, now: float) -> None:
        if self.state == _OPEN \
                and now - self.opened_at >= self.cooldown:
            self.transition(_HALF_OPEN)
            self.probe_inflight = False

    def record_outcome(self, ok: bool, probe: bool) -> None:
        if probe:
            self.probe_inflight = False
            # mixed one-shot + decode traffic shares ONE tenant
            # breaker: whichever path carried the probe decides
            self.transition(_CLOSED if ok else _OPEN)
            self.outcomes.clear()
            return
        if self.state != _CLOSED:
            return
        self.outcomes.append(ok)
        n = len(self.outcomes)
        if n >= self.min_samples:
            rate = self.outcomes.count(False) / n
            if rate >= self.failure_rate:
                self.transition(_OPEN)
                self.outcomes.clear()


class SharedLadderBudget:
    """One LRU accountant over every attached model's bucket ladder.

    Each :class:`~znicz_tpu_torch.export.ExportedModel` joins with
    ``attach_program_budget(budget, key, priority)``; a program made
    resident charges its bytes and a slot here, a hit refreshes its
    recency.  When a cap (``max_programs`` or ``max_bytes``) is
    exceeded, the victim is the least recently used program of the
    lowest-priority attached model (the largest priority number), never
    the program just charged, so memory pressure degrades the cheapest
    tenant's ladder first instead of failing an allocation.

    Registration also charges each model's weight bytes
    (:meth:`~znicz_tpu_torch.export.ExportedModel.weights_nbytes`)
    against ``max_bytes`` as an entry that is never evicted: an int8
    bundle at about half the f32 bytes leaves room for more buckets."""

    def __init__(self, max_programs: int | None = None,
                 max_bytes: int | None = None,
                 fleet: str | None = None) -> None:
        if max_programs is None and max_bytes is None:
            raise ValueError("give max_programs and/or max_bytes")
        self.max_programs = max_programs
        self.max_bytes = max_bytes
        self.fleet = fleet or "fleet"
        self._lock = threading.RLock()
        #: key -> (model, priority)
        self._models: dict[str, tuple] = {}
        #: (key, size) -> nbytes, LRU order (oldest first)
        self._entries: "OrderedDict[tuple, int]" = OrderedDict()
        #: key -> resident weight bytes (protected — never a victim)
        self._weights: dict[str, int] = {}
        self.evictions = 0

    def register(self, key: str, model, priority: int) -> None:
        with self._lock:
            self._models[str(key)] = (model, int(priority))
            nbytes = getattr(model, "weights_nbytes", None)
            self._weights[str(key)] = (int(nbytes())
                                       if callable(nbytes) else 0)

    def touch(self, key: str, size: int) -> None:
        with self._lock:
            if (key, size) in self._entries:
                self._entries.move_to_end((key, size))

    def forget(self, key: str, size: int) -> None:
        with self._lock:
            self._entries.pop((key, size), None)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return (sum(self._entries.values())
                    + sum(self._weights.values()))

    @property
    def programs(self) -> int:
        return len(self._entries)

    def _over(self) -> bool:
        if self.max_programs is not None \
                and len(self._entries) > self.max_programs:
            return True
        return (self.max_bytes is not None
                and sum(self._entries.values())
                + sum(self._weights.values()) > self.max_bytes)

    def _pick_victim(self, protect: tuple) -> tuple | None:
        """LRU entry of the lowest-priority model, skipping the entry
        being charged."""
        worst_prio = None
        victim = None
        for entry in self._entries:  # oldest → newest
            if entry == protect:
                continue
            prio = self._models.get(entry[0], (None, 0))[1]
            if worst_prio is None or prio > worst_prio:
                worst_prio, victim = prio, entry
        return victim

    def charge(self, key: str, size: int, nbytes: int) -> None:
        victims = []
        with self._lock:
            self._entries[(key, size)] = int(nbytes)
            self._entries.move_to_end((key, size))
            while self._over():
                victim = self._pick_victim((key, size))
                if victim is None:
                    break  # only the protected entry remains
                self._entries.pop(victim)
                victims.append(victim)
                self.evictions += 1
        # programs drop outside the budget lock (each drop takes the
        # victim model's lock)
        for vkey, vsize in victims:
            model = self._models.get(vkey, (None, 0))[0]
            if model is not None:
                model.drop_program(vsize)
            _metrics.fleet_ladder_evictions(self.fleet, vkey).inc()

    def stats(self) -> dict:
        with self._lock:
            per_model: dict[str, int] = {}
            for key, _size in self._entries:
                per_model[key] = per_model.get(key, 0) + 1
            return {"programs": len(self._entries),
                    "bytes": (sum(self._entries.values())
                              + sum(self._weights.values())),
                    "program_bytes": sum(self._entries.values()),
                    "weight_bytes": dict(self._weights),
                    "max_programs": self.max_programs,
                    "max_bytes": self.max_bytes,
                    "evictions": self.evictions,
                    "per_model": per_model}


class ReplicaGroup(Logger):
    """N dispatch replicas for one (model, version).

    A replica is a full engine (ServingEngine or DecodeEngine) with
    its own scheduler thread, batcher, breaker and staging buffers.
    One-shot replicas share the version's ``ExportedModel``: its ladder
    of CUDA graphs and its weights are resident once, so a new replica
    (scale-up, repair after ``fleet.replica_loss``) captures nothing
    once the first one warmed.  Requests go round robin over the live
    replicas, skipping any whose breaker is open."""

    def __init__(self, fleet_id: str, model_id: str, version: str,
                 factory, *, target: int = 1,
                 max_replicas: int = 4) -> None:
        super().__init__()
        self.fleet_id = fleet_id
        self.model_id = model_id
        self.version = version
        self._factory = factory
        self.target = int(target)
        self.max_replicas = int(max_replicas)
        self._replicas: list = []
        self._rr = itertools.count()
        self._replica_seq = itertools.count()
        self._lock = threading.Lock()
        self._m_replicas = _metrics.fleet_replicas(
            fleet_id, f"{model_id}@{version}")
        #: replica ids the SDC shadow audit removed (the serving side's
        #: corrupt-chip quarantine)
        self.sdc_quarantined: list[str] = []

    def live(self) -> int:
        return len(self._replicas)

    def engines(self) -> list:
        with self._lock:
            return list(self._replicas)

    def scale_to(self, n: int, reason: str = "manual") -> int:
        """Grow/shrink to ``n`` live replicas (clamped to
        [0, max_replicas]); returns the delta.  Shrink drains: the
        removed engine's shutdown serves everything it admitted."""
        n = max(0, min(int(n), self.max_replicas))
        started, stopped = [], []
        with self._lock:
            while len(self._replicas) < n:
                eng = self._factory()
                # replica identity and the quarantine hook of the SDC
                # shadow audit (unused by engines without one)
                eng.sdc_replica = (f"{self.model_id}@{self.version}"
                                   f"#r{next(self._replica_seq)}")
                eng.on_sdc_suspect = self.quarantine_replica
                self._replicas.append(eng)
                started.append(eng)
            while len(self._replicas) > n:
                stopped.append(self._replicas.pop())
        for eng in started:
            eng.start()
        for eng in stopped:  # outside the lock: shutdown drains
            eng.shutdown()
        delta = len(started) - len(stopped)
        if delta:
            self.target = n if reason != "repair" else self.target
            self._m_replicas.set(self.live())
            _recorder.record("scale",
                             group=f"{self.model_id}@{self.version}",
                             reason=reason, delta=delta,
                             live=self.live())
            self.info("replica group %s@%s scaled to %d (%s)",
                      self.model_id, self.version, self.live(), reason)
        return delta

    def kill_one(self) -> bool:
        """Chaos: drop one live replica WITHOUT draining bookkeeping
        (``fleet.replica_loss``) — the autoscaler's repair path must
        bring the group back to target."""
        with self._lock:
            if not self._replicas:
                return False
            eng = self._replicas.pop(0)
        self._m_replicas.set(self.live())
        _recorder.record("replica_loss",
                         group=f"{self.model_id}@{self.version}",
                         live=self.live())
        eng.shutdown(timeout=30.0)
        self.warning("replica of %s@%s lost (chaos) — %d live",
                     self.model_id, self.version, self.live())
        return True

    def quarantine_replica(self, eng) -> bool:
        """Remove a replica the shadow audit found corrupt from the
        routing set (``znicz_sdc_quarantined_total{kind=replica}``).
        Its shutdown drains on a helper thread, because this runs on
        the suspect engine's own scheduler thread (its queued batches
        serve oracle-corrected replies); the autoscaler's repair, or
        ``scale_to(target, reason="repair")``, restores the capacity
        with no capture."""
        with self._lock:
            if eng not in self._replicas:
                return False
            self._replicas.remove(eng)
            self.sdc_quarantined.append(
                getattr(eng, "sdc_replica", "?"))
        self._m_replicas.set(self.live())
        _metrics.sdc_quarantined("replica").inc()
        _recorder.record("sdc_quarantine",
                         group=f"{self.model_id}@{self.version}",
                         replica=getattr(eng, "sdc_replica", "?"),
                         live=self.live())
        self.warning(
            "replica %s of %s@%s QUARANTINED by the SDC shadow audit "
            "— %d live", getattr(eng, "sdc_replica", "?"),
            self.model_id, self.version, self.live())
        threading.Thread(target=eng.shutdown, name="sdc-quarantine",
                         daemon=True).start()
        return True

    def pick(self):
        """The next live replica (round robin), skipping breaker-open and
        SDC-suspect ones; None when the group is empty or all shed."""
        with self._lock:
            replicas = list(self._replicas)
        if not replicas:
            return None
        start = next(self._rr)
        for i in range(len(replicas)):
            eng = replicas[(start + i) % len(replicas)]
            if getattr(eng, "breaker_state", "closed") != "open" \
                    and not getattr(eng, "sdc_suspect", False):
                return eng
        return None


class _Version:
    """One traffic-weighted version of a fleet model."""

    __slots__ = ("label", "weight", "current", "group", "model",
                 "source", "quant")

    def __init__(self, label: str, weight: float, group: ReplicaGroup,
                 model, source, quant: bool = False) -> None:
        self.label = label
        self.weight = float(weight)
        self.current = 0.0  # smooth weighted round-robin credit
        self.group = group
        self.model = model  # shared ExportedModel (one-shot) or None
        self.source = source
        self.quant = bool(quant)  # bundle carries an int8 quant record


class _FleetModel:
    """A registered model: kind, SLO priority, versions + weights."""

    __slots__ = ("model_id", "kind", "priority", "versions",
                 "input_shape")

    def __init__(self, model_id: str, kind: str, priority: int,
                 input_shape: tuple | None) -> None:
        self.model_id = model_id
        self.kind = kind  # "oneshot" | "lm"
        self.priority = int(priority)
        self.versions: "OrderedDict[str, _Version]" = OrderedDict()
        self.input_shape = input_shape

    def pick_version(self) -> _Version:
        """Smooth weighted round-robin: exact fractions over any
        window, deterministic (no RNG in the request path)."""
        versions = [v for v in self.versions.values() if v.weight > 0]
        if not versions:
            raise RuntimeError(
                f"model '{self.model_id}' has no version with "
                f"traffic weight > 0")
        total = sum(v.weight for v in versions)
        best = None
        for v in versions:
            v.current += v.weight
            if best is None or v.current > best.current:
                best = v
        best.current -= total
        return best


class FleetEngine(Logger):
    """N models, one process, per-tenant SLOs (see module docstring).

    Usage::

        fleet = FleetEngine(tenants=[
            TenantClass("hi", priority=0),
            TenantClass("lo", priority=2, rate=200, burst=50,
                        deadline_ms=250, max_queue_rows=64),
        ])
        fleet.add_model("scorer", "scorer.npz", max_batch=16)
        fleet.add_model("lm", "lm.npz", kind="lm", max_slots=6)
        fleet.start()
        probs  = fleet.submit("scorer", x, tenant="hi").result()
        tokens = fleet.submit("lm", prompt, tenant="lo").result()
        fleet.tick()        # autoscaler + chaos sites
        fleet.shutdown()

    On a machine without a GPU, ``FleetEngine(..., device="cpu")``."""

    def __init__(self, *, tenants: list[TenantClass] | None = None,
                 default_tenant: str = "default",
                 name: str | None = None,
                 max_programs: int | None = None,
                 max_program_bytes: int | None = None,
                 breaker_failure_rate: float = 0.5,
                 breaker_window: int = 16,
                 breaker_min_samples: int = 4,
                 breaker_cooldown_ms: float = 500.0,
                 autoscale: bool = True,
                 max_replicas: int = 4,
                 replicate: bool | None = None,
                 device=None) -> None:
        super().__init__()
        self._obs_id = name or f"fleet#{next(_FLEET_SEQ)}"
        self._lock = threading.RLock()
        self._breaker_cfg = (breaker_failure_rate, breaker_window,
                             breaker_min_samples, breaker_cooldown_ms)
        self._tenants: dict[str, _TenantState] = {}
        self.default_tenant = default_tenant
        for cls in (tenants or []):
            self.add_tenant(cls)
        if default_tenant not in self._tenants:
            self.add_tenant(TenantClass(default_tenant, priority=1))
        self.budget = None
        if max_programs is not None or max_program_bytes is not None:
            self.budget = SharedLadderBudget(
                max_programs=max_programs, max_bytes=max_program_bytes,
                fleet=self._obs_id)
        self._models: "OrderedDict[str, _FleetModel]" = OrderedDict()
        self._m_models = _metrics.fleet_models(self._obs_id)
        self.max_replicas = int(max_replicas)
        self._replicate = replicate
        #: the device every model loads on, resolved once (``device``,
        #: else the card)
        self._device = device
        self.autoscaler = (FleetAutoscaler(self) if autoscale else None)
        self._federator = None
        self._started = False

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def add_tenant(self, cls: TenantClass | str, **kwargs
                   ) -> TenantClass:
        if isinstance(cls, str):
            cls = TenantClass(cls, **kwargs)
        with self._lock:
            if cls.name in self._tenants:
                raise ValueError(f"tenant '{cls.name}' already exists")
            self._tenants[cls.name] = _TenantState(
                self._obs_id, cls, *self._breaker_cfg)
        return cls

    def tenant(self, name: str) -> TenantClass:
        return self._tenant_state(name).cls

    def _tenant_state(self, name: str) -> _TenantState:
        state = self._tenants.get(name)
        if state is None:
            raise KeyError(
                f"unknown tenant '{name}' — add_tenant() it first "
                f"(known: {sorted(self._tenants)})")
        return state

    def _resolve_device(self):
        if self._device is None:
            from znicz_tpu_torch.serving.engine import ServingEngine
            device = ServingEngine.resolve_device(self._replicate)
            # one shared model a version: on the first card of several
            self._device = device[0] if isinstance(device, list) \
                else device
        return self._device

    def add_model(self, model_id: str, source, *, kind: str | None = None,
                  version: str = "v1", weight: float = 1.0,
                  priority: int | None = None, replicas: int = 1,
                  max_replicas: int | None = None,
                  **engine_kwargs) -> None:
        """Register a model (its first version).  ``source`` is a
        bundle path or an :class:`~znicz_tpu_torch.export.ExportedModel`;
        ``kind`` defaults to the bundle manifest's (``lm`` bundles
        serve through a :class:`~znicz_tpu_torch.serving.DecodeEngine`,
        scorers through a :class:`~znicz_tpu_torch.serving.ServingEngine`).
        ``priority`` is the model's class in the shared ladder's
        eviction order (default: the lowest, largest, tenant priority).
        ``engine_kwargs`` pass through to every replica engine
        (``max_batch``, ``max_slots``, …)."""
        with self._lock:
            if model_id in self._models:
                raise ValueError(f"model '{model_id}' already "
                                 f"registered — use add_version()")
        if priority is None:
            priority = max((s.cls.priority
                            for s in self._tenants.values()),
                           default=1)
        entry = self._build_version(model_id, source, kind, version,
                                    weight, int(priority), replicas,
                                    max_replicas, engine_kwargs)
        kind = entry[0]
        with self._lock:
            model = _FleetModel(model_id, kind, int(priority),
                                entry[2])
            model.versions[version] = entry[1]
            self._models[model_id] = model
            self._m_models.set(len(self._models))
        _metrics.fleet_traffic_weight(self._obs_id, model_id,
                                      version).set(weight)
        self._refresh_quant_gauge()
        if self._started:
            entry[1].group.scale_to(replicas, reason="up")

    def add_version(self, model_id: str, source, *,
                    version: str, weight: float = 0.0,
                    replicas: int = 1, max_replicas: int | None = None,
                    **engine_kwargs) -> None:
        """Add another traffic-weighted version of a registered model
        (any number of versions, any fractions)."""
        model = self._models[model_id]
        if version in model.versions:
            raise ValueError(f"{model_id}@{version} already exists")
        entry = self._build_version(model_id, source, model.kind,
                                    version, weight, model.priority,
                                    replicas, max_replicas,
                                    engine_kwargs)
        with self._lock:
            model.versions[version] = entry[1]
        _metrics.fleet_traffic_weight(self._obs_id, model_id,
                                      version).set(weight)
        self._refresh_quant_gauge()
        if self._started:
            entry[1].group.scale_to(replicas, reason="up")

    def _refresh_quant_gauge(self) -> None:
        """``znicz_quantized_models``: the int8 model versions
        registered."""
        with self._lock:
            n = sum(1 for m in self._models.values()
                    for v in m.versions.values() if v.quant)
        _metrics.quantized_models(self._obs_id).set(n)

    def _build_version(self, model_id: str, source, kind: str | None,
                       version: str, weight: float, priority: int,
                       replicas: int, max_replicas: int | None,
                       engine_kwargs: dict) -> tuple:
        """Resolve (kind, _Version, input_shape) for one source."""
        from znicz_tpu_torch.export import ExportedModel, read_bundle
        from znicz_tpu_torch.serving.decode import DecodeEngine
        from znicz_tpu_torch.serving.engine import ServingEngine
        shared_model = None
        input_shape = None
        if isinstance(source, ExportedModel):
            shared_model = source
            manifest = source.manifest
        elif isinstance(source, (str, bytes)) \
                or hasattr(source, "__fspath__"):
            manifest, _params = read_bundle(source)
        else:
            raise TypeError(f"cannot serve {type(source).__name__}: "
                            f"pass a bundle path or an ExportedModel")
        if kind is None:
            kind = "lm" if manifest.get("kind") == "lm" else "oneshot"
        if kind not in ("oneshot", "lm"):
            raise ValueError(f"kind must be 'oneshot' or 'lm', "
                             f"got {kind!r}")
        cap = (max_replicas if max_replicas is not None
               else self.max_replicas)
        if kind == "oneshot":
            max_batch = int(engine_kwargs.pop("max_batch", 16))
            if shared_model is None:
                shared_model = ExportedModel.load(
                    source, device=self._resolve_device(),
                    max_batch=max_batch)
            input_shape = shared_model.input_shape
            if self.budget is not None:
                shared_model.attach_program_budget(
                    self.budget, key=f"{model_id}@{version}",
                    priority=priority)
            kwargs = dict(engine_kwargs)

            def factory(model=shared_model, kwargs=kwargs,
                        max_batch=max_batch):
                return ServingEngine(model, max_batch=max_batch,
                                     **kwargs)
        else:
            if shared_model is not None:
                raise TypeError(
                    "decode models are registered by bundle PATH — "
                    "each replica builds its own KV-cache state")
            kwargs = dict(engine_kwargs)

            def factory(source=source, kwargs=kwargs,
                        device=self._resolve_device()):
                return DecodeEngine(source, device=device, **kwargs)
        group = ReplicaGroup(self._obs_id, model_id, version, factory,
                             target=replicas, max_replicas=cap)
        return kind, _Version(version, weight, group, shared_model,
                              source,
                              quant=bool(manifest.get("quant"))
                              ), input_shape

    def set_traffic(self, model_id: str,
                    weights: dict[str, float]) -> None:
        """Set the A/B traffic split across a model's versions —
        arbitrary fractions (they need not sum to 1; routing
        normalizes).  A version absent from ``weights`` keeps its
        current weight; weight 0 drains a version out of the split
        without tearing its replicas down."""
        model = self._models[model_id]
        with self._lock:
            for label, weight in weights.items():
                if label not in model.versions:
                    raise KeyError(f"{model_id}@{label} not registered")
                if weight < 0:
                    raise ValueError(f"weight must be >= 0, "
                                     f"got {weight}")
                model.versions[label].weight = float(weight)
                model.versions[label].current = 0.0
        for label, weight in weights.items():
            _metrics.fleet_traffic_weight(self._obs_id, model_id,
                                          label).set(weight)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "FleetEngine":
        if self._started:
            return self
        for model in self._models.values():
            for v in model.versions.values():
                v.group.scale_to(max(1, v.group.target), reason="up")
        if _metrics.enabled() and self._federator is None:
            # tick() doubles as the fleet's federation cadence: one
            # in-process source re-labels every replica engine's
            # series under its model@version "pool"
            from znicz_tpu_torch.observe.federation import Federator
            self._federator = Federator(self._obs_id)
            self._federator.add_registry("self",
                                         pool_of=self._fed_pool_of)
        self._started = True
        self.info("fleet '%s': %d models resident, tenants=%s",
                  self._obs_id, len(self._models),
                  sorted(self._tenants))
        return self

    def shutdown(self, timeout: float = 60.0) -> None:
        for model in self._models.values():
            for v in model.versions.values():
                for eng in v.group.engines():
                    eng.shutdown(timeout=timeout)
                v.group.scale_to(0, reason="down")
        if self._federator is not None:
            self._federator.close()
            self._federator = None
        self._started = False

    def _fed_pool_of(self, eng_label: str):
        """Map a replica engine's label to its ``model@version`` fed
        pool (None: not one of this fleet's replicas)."""
        for model in self._models.values():
            for v in model.versions.values():
                for e in v.group.engines():
                    if getattr(e, "_obs_id", None) == eng_label:
                        return f"{model.model_id}@{v.label}"
        return None

    def __enter__(self) -> "FleetEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, model_id: str, x, *, tenant: str | None = None,
               version: str | None = None,
               deadline_ms: float | None = None,
               max_new_tokens: int | None = None,
               retry_budget: int | None = None) -> Future:
        """Route one request: tenant admission (breaker → token
        bucket) → version pick (weighted A/B, or pinned via
        ``version``) → replica pick (round-robin, breaker-open
        skipped) → engine submit carrying the tenant's priority,
        deadline and retry budget.  Sheds raise
        :class:`Overloaded`/:class:`QueueFull`; every outcome lands on
        this tenant's counters, latency window and breaker."""
        if not self._started:
            raise RuntimeError("fleet not started — call start()")
        t0 = time.monotonic()
        tname = tenant or self.default_tenant
        state = self._tenant_state(tname)
        cls = state.cls
        model = self._models.get(model_id)
        if model is None:
            raise KeyError(f"unknown model '{model_id}' "
                           f"(known: {sorted(self._models)})")
        # the trace starts here (routing is the request's first hop)
        # and reaches the engine's submit through the pending-trace
        # channel
        trace = _tracing.new_request_trace("request", model=model_id,
                                           tenant=tname)

        def _shed(event: str) -> None:
            _metrics.trace_requests(self._obs_id, "shed").inc()
            trace.event(event, fleet=self._obs_id, tenant=tname)
            trace.finish("shed")
        probe = False
        with self._lock:
            state.breaker_tick(t0)
            if state.state == _OPEN:
                state.count("shed")
                _shed("breaker_shed")
                raise Overloaded(
                    f"tenant '{tname}' breaker open — load shed "
                    f"(retry after {state.cooldown * 1e3:.0f}ms)")
            if state.state == _HALF_OPEN:
                if state.probe_inflight:
                    state.count("shed")
                    _shed("breaker_shed")
                    raise Overloaded(
                        f"tenant '{tname}' breaker half-open — probe "
                        f"in flight")
                state.probe_inflight = True
                probe = True
        cost = (int(np.shape(x)[0])
                if model.kind == "oneshot" and np.ndim(x) > 1 else 1)
        if not state.bucket.try_acquire(cost):
            with self._lock:
                state.count("shed")
                # sustained rate-limit shedding IS the flood signal:
                # it feeds the tenant breaker so a flooding tenant
                # degrades to instant rejection
                state.record_outcome(False, probe)
            _shed("rate_limit_shed")
            raise Overloaded(
                f"tenant '{tname}' rate limit — token bucket empty "
                f"(rate={cls.rate}/s, burst={cls.burst})")
        if deadline_ms is None:
            deadline_ms = cls.deadline_ms
        if retry_budget is None:
            retry_budget = cls.retry_budget
        with self._lock:
            v = (model.versions[version] if version is not None
                 else model.pick_version())
        engine = v.group.pick()
        if engine is None:
            with self._lock:
                state.count("shed")
                state.record_outcome(False, probe)
            _shed("no_replica_shed")
            raise Overloaded(
                f"no live replica for {model_id}@{v.label}")
        # the A/B choice + replica pick land on the trace, then the
        # trace parks on this thread for the engine's request
        # constructor to adopt (same-thread synchronous submit)
        trace.event("fleet_route", fleet=self._obs_id,
                    model=model_id, version=v.label,
                    replica=getattr(engine, "sdc_replica", "?"))
        _tracing.set_pending_trace(trace)
        try:
            if model.kind == "lm":
                future = engine.submit(
                    x, max_new_tokens=max_new_tokens,
                    deadline_ms=deadline_ms, tenant=tname,
                    priority=cls.priority)
            else:
                future = engine.submit(
                    x, deadline_ms=deadline_ms, tenant=tname,
                    priority=cls.priority, retry_budget=retry_budget,
                    tenant_max_rows=cls.max_queue_rows)
        except Exception as exc:  # noqa: BLE001 — probe must not leak
            # an engine that raised before constructing its request
            # never adopted the parked trace — clear it so the NEXT
            # request on this thread cannot inherit it
            leftover = _tracing.adopt_pending_trace()
            if leftover is not None:
                _metrics.trace_requests(self._obs_id, "shed").inc()
                leftover.finish("shed")
            with self._lock:
                state.count("shed" if isinstance(
                    exc, (QueueFull, DeadlineExceeded)) else "failed")
                state.record_outcome(False, probe)
            raise
        _tracing.adopt_pending_trace()  # engine took it; clear if not
        with self._lock:
            state.count("submitted")
        future.add_done_callback(
            lambda f, s=state, t=t0, p=probe: self._on_done(s, t, f, p))
        return future

    def __call__(self, model_id: str, x, timeout: float | None = None,
                 **kwargs):
        """Synchronous convenience: submit + wait."""
        return self.submit(model_id, x, **kwargs).result(
            timeout=timeout)

    def _on_done(self, state: _TenantState, t0: float, future: Future,
                 probe: bool) -> None:
        """Outcome accounting (runs on engine scheduler threads —
        keep it lock-light, never call back into an engine).

        Latency semantics per request kind: one-shot scoring observes
        submit→reply; GENERATION observes submit→first-token (the
        decode engine stamps ``ttft_s`` on the future) — TTFT is the
        scheduling-bound SLO the fleet controls, while completion
        time is proportional to the tokens requested, so an SLO on it
        would conflate the work's size with admission latency."""
        exc = future.exception()
        with self._lock:
            if exc is None:
                state.count("served")
                ttft = getattr(future, "ttft_s", None)
                state.observe_latency(ttft if ttft is not None
                                      else time.monotonic() - t0)
                state.record_outcome(True, probe)
            elif isinstance(exc, DeadlineExceeded):
                state.count("expired")
                state.record_outcome(False, probe)
            elif isinstance(exc, QueueFull):  # preempted / shed late
                state.count("shed")
                state.record_outcome(False, probe)
            else:
                state.count("failed")
                state.record_outcome(False, probe)

    # ------------------------------------------------------------------
    # maintenance: chaos sites + autoscaler
    # ------------------------------------------------------------------
    def tick(self) -> list[str]:
        """One control-plane step (drive from any host loop): fires
        the fleet chaos sites when a plan says so, then runs one
        autoscaler pass.  Returns human-readable events."""
        events: list[str] = []
        payload = _faults.fire("fleet.tenant_flood")
        if payload is not None:
            self._inject_flood(payload, events)
        payload = _faults.fire("fleet.replica_loss")
        if payload is not None:
            self._kill_replica(payload, events)
        if self.autoscaler is not None:
            events.extend(self.autoscaler.tick())
        if self._federator is not None:
            self._federator.scrape()
        return events

    def _flood_tenant(self) -> str:
        """The lowest-priority tenant (chaos default)."""
        return max(self._tenants.values(),
                   key=lambda s: s.cls.priority).cls.name

    def _inject_flood(self, payload: dict, events: list[str]) -> None:
        tname = payload.get("tenant") or self._flood_tenant()
        n = int(payload.get("n", 32))
        model_id = payload.get("model")
        if model_id is None:
            candidates = [m for m in self._models.values()
                          if m.kind == "oneshot"] \
                or list(self._models.values())
            if not candidates:
                return
            model_id = candidates[0].model_id
        model = self._models[model_id]
        shed = served = 0
        for _i in range(n):
            try:
                if model.kind == "lm":
                    self.submit(model_id, np.zeros(1, np.int32),
                                tenant=tname, max_new_tokens=1)
                else:
                    self.submit(
                        model_id,
                        np.zeros((1,) + tuple(model.input_shape),
                                 np.float32), tenant=tname)
                served += 1
            except QueueFull:  # Overloaded included — the flood sheds
                shed += 1
        _metrics.recoveries("tenant_flood_absorbed").inc()
        msg = (f"injected flood: {n} requests on tenant '{tname}' → "
               f"{served} admitted, {shed} shed inside the class")
        self.warning(msg)
        events.append(msg)

    def _kill_replica(self, payload: dict, events: list[str]) -> None:
        model_id = payload.get("model") \
            or next(iter(self._models), None)
        if model_id is None:
            return
        model = self._models[model_id]
        for v in model.versions.values():
            if v.group.live() > 0:
                v.group.kill_one()
                msg = (f"injected replica loss on "
                       f"{model_id}@{v.label} — {v.group.live()} live,"
                       f" awaiting autoscaler repair")
                events.append(msg)
                return

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def tenant_stats(self, name: str) -> dict:
        state = self._tenant_state(name)
        with self._lock:
            win = sorted(state.latency_win)
            out = {"priority": state.cls.priority,
                   "rate": state.cls.rate,
                   "breaker": state.state,
                   "tokens": round(state.bucket.level, 1),
                   **dict(state.counts)}
        if win:
            def pct(q):
                idx = min(len(win) - 1,
                          max(0, int(round(q / 100 * (len(win) - 1)))))
                return round(1e3 * win[idx], 3)
            out["latency_ms"] = {"p50": pct(50), "p95": pct(95),
                                 "p99": pct(99), "window": len(win)}
        return out

    def stats(self) -> dict:
        models: dict = {}
        for model in self._models.values():
            versions = {}
            for v in model.versions.values():
                versions[v.label] = {
                    "weight": v.weight,
                    "replicas": v.group.live(),
                    "target": v.group.target,
                    "quant": v.quant,
                    "served": sum(
                        int(e.stats().get("served", 0))
                        for e in v.group.engines()),
                }
            models[model.model_id] = {
                "kind": model.kind, "priority": model.priority,
                "versions": versions}
        out = {
            "engine": "fleet",
            "fleet": self._obs_id,
            "models": models,
            "tenants": {name: self.tenant_stats(name)
                        for name in sorted(self._tenants)},
        }
        if self.budget is not None:
            out["ladder_budget"] = self.budget.stats()
        return out

    def ready(self) -> bool:
        """Every model has at least one live replica (a single
        tenant's open breaker does NOT make the process unready — it
        sheds exactly that tenant)."""
        return bool(self._started and all(
            any(v.group.live() > 0 for v in m.versions.values())
            for m in self._models.values()))

    def serving_status(self) -> dict:
        """``web_status.gather_status`` hook."""
        out = {"name": f"fleet:{self._obs_id}",
               "initialized": self._started,
               "stopped": not self._started}
        out.update(self.stats())
        return out


class FleetAutoscaler:
    """Replica autoscaling from the existing canonical series.

    Per (model, version) group each :meth:`tick`:

    - **repair** — live < target (a ``fleet.replica_loss`` or a died
      engine): scale back to target immediately
      (``znicz_fleet_scale_events_total{op=repair}`` +
      ``znicz_recoveries_total{kind=replica_respawn}``);
    - **up** — the group's worst replica queue age
      (``znicz_serving_queue_age_seconds``) exceeds
      ``queue_age_up_s``, or its cumulative bucket occupancy
      (``znicz_serving_bucket_rows_total`` /
      ``znicz_serving_bucket_batches_total`` × bucket) exceeds
      ``occupancy_up`` while queue rows are pending — and live <
      max_replicas;
    - **down** — the group has been idle (zero queue age and no new
      served work) for ``idle_down_s`` and live > min_replicas.

    Decode groups take part in repair only: a decode engine's slot
    occupancy is already its KV pool's admission currency, and a whole
    extra engine captures its own programs.  The disaggregated engine's
    pools share one model's programs; :class:`PoolAutoscaler` scales
    them."""

    def __init__(self, fleet: FleetEngine, *,
                 queue_age_up_s: float = 0.25,
                 occupancy_up: float = 0.9,
                 idle_down_s: float = 5.0,
                 min_replicas: int = 1,
                 cooldown_s: float = 0.5) -> None:
        self.fleet = fleet
        self.queue_age_up_s = float(queue_age_up_s)
        self.occupancy_up = float(occupancy_up)
        self.idle_down_s = float(idle_down_s)
        self.min_replicas = int(min_replicas)
        self.cooldown_s = float(cooldown_s)
        self._last_scale: dict[tuple, float] = {}
        self._last_busy: dict[tuple, float] = {}
        self._last_served: dict[tuple, int] = {}

    # -- canonical-series readers --------------------------------------
    @staticmethod
    def _gauge_for(series: str, engine_id: str) -> float:
        fam = _metrics.REGISTRY.get(series)
        if fam is None:
            return 0.0
        for key, child in fam.items():
            if key[0] == engine_id:
                return float(child.value)
        return 0.0

    @staticmethod
    def _occupancy_for(engine_id: str) -> float:
        rows_fam = _metrics.REGISTRY.get(
            "znicz_serving_bucket_rows_total")
        batches_fam = _metrics.REGISTRY.get(
            "znicz_serving_bucket_batches_total")
        if rows_fam is None or batches_fam is None:
            return 0.0
        rows = sum(child.value for key, child in rows_fam.items()
                   if key[0] == engine_id)
        capacity = sum(child.value * float(key[1])
                       for key, child in batches_fam.items()
                       if key[0] == engine_id)
        return rows / capacity if capacity else 0.0

    def tick(self) -> list[str]:
        events: list[str] = []
        now = time.monotonic()
        for model in list(self.fleet._models.values()):
            for v in model.versions.values():
                events.extend(self._tick_group(model, v, now))
        return events

    def _tick_group(self, model: _FleetModel, v: _Version,
                    now: float) -> list[str]:
        events: list[str] = []
        group = v.group
        gkey = (model.model_id, v.label)
        live = group.live()
        if live < group.target and self.fleet._started:
            group.scale_to(group.target, reason="repair")
            _metrics.fleet_scale_events(self.fleet._obs_id,
                                        f"{model.model_id}@{v.label}",
                                        "repair").inc()
            _metrics.recoveries("replica_respawn").inc()
            events.append(f"repaired {model.model_id}@{v.label} → "
                          f"{group.live()} replicas")
            self._last_scale[gkey] = now
            return events
        if model.kind != "oneshot":
            return events  # decode groups: repair-only (see class doc)
        engines = group.engines()
        if not engines:
            return events
        ages = [self._gauge_for("znicz_serving_queue_age_seconds",
                                e._obs_id) for e in engines]
        queue_rows = [self._gauge_for("znicz_serving_queue_rows",
                                      e._obs_id) for e in engines]
        occ = max((self._occupancy_for(e._obs_id) for e in engines),
                  default=0.0)
        served = sum(int(e.stats().get("served", 0)) for e in engines)
        busy = (max(ages, default=0.0) > 0.0
                or sum(queue_rows) > 0
                or served != self._last_served.get(gkey, -1))
        self._last_served[gkey] = served
        if busy:
            self._last_busy[gkey] = now
        if now - self._last_scale.get(gkey, 0.0) < self.cooldown_s:
            return events
        if (max(ages, default=0.0) > self.queue_age_up_s
            or (occ > self.occupancy_up and sum(queue_rows) > 0)) \
                and live < group.max_replicas:
            group.scale_to(live + 1, reason="up")
            _metrics.fleet_scale_events(self.fleet._obs_id,
                                        f"{model.model_id}@{v.label}",
                                        "up").inc()
            events.append(
                f"scaled {model.model_id}@{v.label} up → "
                f"{group.live()} (queue_age={max(ages):.2f}s, "
                f"occupancy={occ:.2f})")
            self._last_scale[gkey] = now
        elif (live > self.min_replicas
              and now - self._last_busy.get(gkey, now)
              > self.idle_down_s):
            group.scale_to(live - 1, reason="down")
            _metrics.fleet_scale_events(self.fleet._obs_id,
                                        f"{model.model_id}@{v.label}",
                                        "down").inc()
            events.append(f"scaled {model.model_id}@{v.label} down → "
                          f"{group.live()} (idle)")
            self._last_scale[gkey] = now
        return events


class PoolAutoscaler:
    """Per-pool replica autoscaling for a disaggregated engine (port of
    the reference's ``PoolAutoscaler``).

    ``pools`` maps a pool name (``"prefill"``, ``"decode"``) to its
    :class:`ReplicaGroup`; a pool's signal is its child of
    ``znicz_serving_queue_age_seconds{engine=<engine_id>, pool=<name>}``
    (prefill: the shared prompt queue's head; decode: the oldest handoff
    not yet accepted), so a prompt burst grows the prefill pool without
    touching the decode pool, and a handoff backlog grows decode without
    spending prefill compute.  The replicas share one warmed
    :class:`~znicz_tpu_torch.serving.decode.DecodeModel` and each owns
    one of the caches it planned (:meth:`DecodeModel.make_cache`), so a
    scale-up captures no CUDA graph.

    Each :meth:`tick`, a pool is **repaired** when live < target,
    **grown** when its queue age exceeds ``queue_age_up_s`` and live <
    max_replicas, and **shrunk** to ``min_replicas`` after
    ``idle_down_s`` of zero queue age and no newly served work."""

    def __init__(self, pools: dict[str, ReplicaGroup], engine_id: str, *,
                 queue_age_up_s: float = 0.25, idle_down_s: float = 5.0,
                 min_replicas: int = 1, cooldown_s: float = 0.5) -> None:
        self.pools = dict(pools)
        self.engine_id = engine_id
        self.queue_age_up_s = float(queue_age_up_s)
        self.idle_down_s = float(idle_down_s)
        self.min_replicas = int(min_replicas)
        self.cooldown_s = float(cooldown_s)
        self._last_scale: dict[str, float] = {}
        self._last_busy: dict[str, float] = {}
        self._last_served: dict[str, int] = {}

    def _pool_age(self, pool: str) -> float:
        fam = _metrics.REGISTRY.get("znicz_serving_queue_age_seconds")
        if fam is None:
            return 0.0
        for key, child in fam.items():
            if key[0] == self.engine_id and key[1] == pool:
                return float(child.value)
        return 0.0

    def tick(self) -> list[str]:
        events: list[str] = []
        now = time.monotonic()
        for name, group in self.pools.items():
            events.extend(self._tick_pool(name, group, now))
        return events

    def _scaled(self, name: str, op: str, now: float) -> None:
        _metrics.fleet_scale_events(self.engine_id,
                                    f"{self.engine_id}@{name}", op).inc()
        self._last_scale[name] = now

    def _tick_pool(self, name: str, group: ReplicaGroup,
                   now: float) -> list[str]:
        live = group.live()
        if live < group.target:
            group.scale_to(group.target, reason="repair")
            self._scaled(name, "repair", now)
            _metrics.recoveries("replica_respawn").inc()
            return [f"repaired pool {name} → {group.live()} replicas"]
        age = self._pool_age(name)
        served = sum(int(getattr(e, "served", 0)) for e in group.engines())
        if age > 0.0 or served != self._last_served.get(name, -1):
            self._last_busy[name] = now
        self._last_served[name] = served
        if now - self._last_scale.get(name, 0.0) < self.cooldown_s:
            return []
        if age > self.queue_age_up_s and live < group.max_replicas:
            group.scale_to(live + 1, reason="up")
            self._scaled(name, "up", now)
            return [f"scaled pool {name} up → {group.live()} "
                    f"(queue_age={age:.2f}s)"]
        if live > self.min_replicas \
                and now - self._last_busy.get(name, now) > self.idle_down_s:
            group.scale_to(live - 1, reason="down")
            self._scaled(name, "down", now)
            return [f"scaled pool {name} down → {group.live()} (idle)"]
        return []
