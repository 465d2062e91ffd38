"""Deterministic fault injection: named sites, seeded recipes (copy of
``znicz_tpu/resilience/faults.py``).

The chaos contract: a fault recipe is **configuration**
(``root.common.engine.faults``), every injection point in the
framework is a **named site**, and a given ``(recipe, seed)`` replays
the identical fault sequence — so a chaos soak is as reproducible as
the counter-based shuffle made the data plane.

Usage (the injecting side)::

    from znicz_tpu_torch.resilience import faults as _faults
    if _faults.fire("serving.program_error") is not None:
        raise _faults.FaultInjected("injected serving program failure")

``fire`` returns ``None`` in one dict lookup when no plan is
configured — the zero-overhead-when-off guarantee every hot path
relies on.  When a plan is active, each call counts one *arrival* at
the site (optionally filtered by keyword context, e.g. only arrivals
for ``shard=3``) and the site's spec decides whether this arrival
fires.

Recipe forms (``root.common.engine.faults = {...}``), per site:

- ``3`` or ``[3, 7]`` — fire on exactly those arrival ordinals
  (1-based); each listed arrival is one counted fault event;
- ``{"at": [3]}`` — same, dict form (extra keys become the payload
  and double as context filters);
- ``{"after": 1}`` — fire on every arrival from that ordinal on — a
  *persistent* fault (a corrupt shard stays corrupt); counted as ONE
  fault event no matter how many reads hit it;
- ``{"p": 0.05}`` — fire each arrival with probability p from the
  plan's Philox stream (deterministic per seed); each fire is one
  event;
- ``True`` — shorthand for ``{"after": 1}``.

The reserved recipe key ``"_seed"`` (default 0) seeds the
probabilistic streams.  Any other spec key that also appears in the
``fire`` call's context must match for the arrival to count — e.g.
``{"shard": 1, "after": 1}`` only ever fires for ``fire(site,
shard=1)``.

Every fired event increments ``znicz_faults_injected_total{site}`` so
the dryrun tail and the tests attest injection counts from the same
series ``/metrics`` exposes.

:data:`SITES` keeps every name of the reference's table, so a recipe
valid there is valid here.  The port fires the sites of the modules it
has: ``serving.program_error``, ``serving.latency_spike`` and
``sdc.serving_bitflip`` (``serving/engine.py``),
``snapshot.write_fail`` (``utils/snapshotter.py``),
``quant.calib_corrupt`` (``serving/quantize.py``) and
``observe.recorder_stall`` (``observe/recorder.py``); the others wait
for their modules (ROADMAP.md names the item that owns each).
"""

from __future__ import annotations

import threading
import zlib

import numpy as np

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.utils.config import root

#: the framework's named injection sites (the docstring of record —
#: greppable, and the recipe validator rejects unknown names so a typo
#: fails loudly instead of silently injecting nothing)
SITES = {
    "train.nonfinite_loss":
        "NaN added to the evaluator's per-step loss (rides the guard's "
        "device-resident inject leaf — no recompile)",
    "train.nonfinite_grad":
        "NaN added to the evaluator's err_output seed — every weight "
        "gradient of the step goes non-finite while the loss stays "
        "clean",
    "loader.reader_death":
        "streaming producer thread raises mid-epoch (exercises the "
        "poison-pill propagation + bounded pipeline restart)",
    "loader.corrupt_shard":
        "a shard read raises as if its CRC failed; with {'after': n} "
        "the shard is persistently bad and must be quarantined",
    "loader.short_read":
        "a shard read raises as a transient short read (retry path)",
    "serving.program_error":
        "the serving dispatch raises before touching the AOT program "
        "(exercises the retry budget / breaker)",
    "serving.latency_spike":
        "the serving dispatch sleeps payload 'ms' (default 50) before "
        "running (exercises deadlines + queue-age shedding)",
    "snapshot.write_fail":
        "Snapshotter.write raises OSError mid-write (exercises "
        "tolerate-and-continue + retention of the last good snapshot)",
    "publish.corrupt":
        "publish_bundle corrupts the bundle bytes AFTER computing the "
        "sidecar digest — the serving-side watcher must reject the "
        "file on digest verification and keep the incumbent serving",
    "swap.canary_regress":
        "the candidate's canary score is penalized by payload "
        "'penalty' (default 1.0) so the swap gate must reject the "
        "publish (exercises guard-margin rejection)",
    "swap.probation_fail":
        "the post-promotion probation check reports the freshly "
        "promoted model unhealthy, forcing an automatic rollback to "
        "the prior version",
    "fleet.tenant_flood":
        "FleetEngine.tick injects a burst of payload 'n' (default 32) "
        "synthetic requests for payload 'tenant' (default the lowest-"
        "priority tenant) — admission must shed the flood inside that "
        "tenant's class without moving any other tenant's SLO",
    "fleet.model_corrupt":
        "ForgeRegistry.fetch treats the fetched bundle as failing its "
        "sha256 digest — the registry must QUARANTINE it and fall "
        "back to the newest older good version instead of handing "
        "corrupt bytes to a loader",
    "host.loss":
        "a training step boundary hard-kills this process (os._exit, "
        "no drain, no snapshot) as if the host vanished — filter with "
        "{'process': i}; the elastic supervisor must detect the loss "
        "(child exit / heartbeat timeout), reap the stranded gang, and "
        "restart on the surviving mesh from the newest good snapshot",
    "host.preempt":
        "a step boundary receives a simulated preemption notice "
        "(SIGTERM semantics): the worker supervisor requests the "
        "barriered checkpoint-on-signal and the whole gang exits "
        "EXIT_PREEMPTED after process 0's sha256 sidecar lands — "
        "filter with {'process': i}",
    "heartbeat.stall":
        "the heartbeat writer freezes its step counter while "
        "wall-clock beats continue and the step blocks for payload "
        "'sleep_s' (default 3600) — a hung collective's exact "
        "signature; the monitor must declare the process stalled "
        "within the stall timeout",
    "checkpoint.signal_corrupt":
        "the checkpoint-on-signal bytes are corrupted AFTER the "
        "sidecar digest is computed — resume must reject the file on "
        "digest verification and fall back to the newest older good "
        "snapshot",
    "fleet.replica_loss":
        "FleetEngine.tick kills one live replica of payload 'model' "
        "(default the first model) mid-traffic — routing must steer "
        "around the loss and the autoscaler must repair the group "
        "with zero high-priority request failures",
    "sdc.flip_param":
        "one element of a parameter tensor is silently multiplied by "
        "payload 'factor' (default 2^16) in THIS process's stored "
        "copy, HOST-SIDE between dispatches (an in-program scatter "
        "would be re-sharded by GSPMD onto the element's owner device "
        "and silently no-op on other processes) — the mutation lands "
        "between one step's post-update fingerprint fold and the next "
        "step's pre-update refold, exactly the memory-corruption "
        "signature the guard's sticky self-check localizes; filter "
        "with {'process': i} so ONE gang member diverges and the "
        "cross-replica vote must quarantine it",
    "sdc.flip_grad":
        "one element of the folded weight gradient is multiplied by "
        "payload 'factor' (default 2^16) BEFORE the update (rides the "
        "guard's sdc_inject device leaf — no recompile) — finite, "
        "plausible, wrong: the isfinite guard passes while the "
        "device's update diverges from the shadow oracle; the "
        "redundant-compute audit must catch the mismatch.  Drill "
        "single-process: under multi-process ZeRO-1 GSPMD may assign "
        "the scatter to the element's owner device",
    "sdc.serving_bitflip":
        "a serving replica's reply rows are corrupted post-program "
        "(column 0 scaled by payload 'factor') — plausible-but-wrong "
        "scores; the sampled shadow audit must re-score against the "
        "compile-free numpy oracle, correct the reply, and remove the "
        "replica via the ReplicaGroup repair path; filter with "
        "{'replica': id}",
    "quant.calib_corrupt":
        "publish-time int8 quantization mis-scales every per-channel "
        "weight scale by payload 'factor' (default 64) AFTER the "
        "calibration accuracy gate passed — a calibration bug that "
        "slips publication; the SwapController's canary must reject "
        "the bundle at the guard margin with the f32 incumbent still "
        "serving",
    "disagg.handoff_drop":
        "a prefill→decode page-table handoff is dropped in flight (the "
        "cross-pool transfer fails after the prefill pool already "
        "released its pages) — the DisaggEngine must retry the request "
        "on a fresh prefill pass with its token-budget reservation "
        "kept, reject it only past the retry budget, and leave the "
        "budget balanced() with every page reclaimed",
    "aotcache.corrupt":
        "a persisted AOT executable's payload bytes rot between the "
        "sha256 sidecar write and the next cold-start read (torn "
        "write, bit rot, truncated copy) — the cache's digest gate "
        "must quarantine the entry (renamed aside, never retried), "
        "count recoveries{aotcache_fallback}, and fall back to "
        "tracing with outputs bitwise-equal to the traced arm; a "
        "wrong program must never load",
    "observe.recorder_stall":
        "a flight-recorder journal write stalls/fails as if the disk "
        "filled or the device tore — the recorder must DROP the event "
        "(counting znicz_flightrecord_dropped_total) and return "
        "immediately: no dispatch, swap or restart may ever block on "
        "or fail from ops journaling",
}

#: spec keys that steer firing rather than ride the payload
_CONTROL_KEYS = ("at", "after", "p")


class FaultInjected(RuntimeError):
    """The exception injected faults raise where a real fault would."""


def _normalize(site: str, spec) -> dict:
    if spec is True:
        spec = {"after": 1}
    elif isinstance(spec, (int, np.integer)) and not isinstance(spec, bool):
        spec = {"at": [int(spec)]}
    elif isinstance(spec, (list, tuple)):
        spec = {"at": [int(a) for a in spec]}
    if not isinstance(spec, dict):
        raise ValueError(f"fault site '{site}': bad spec {spec!r}")
    if not any(k in spec for k in _CONTROL_KEYS):
        raise ValueError(
            f"fault site '{site}': spec needs one of {_CONTROL_KEYS}")
    return dict(spec)


class FaultPlan:
    """One chaos recipe: per-site firing specs + deterministic state.

    Thread-safe — loader reader pools, the serving scheduler thread
    and the training control plane all call :meth:`fire` concurrently.
    """

    def __init__(self, recipe: dict, seed: int | None = None) -> None:
        recipe = dict(recipe)
        self.seed = int(recipe.pop("_seed", 0) if seed is None else seed)
        unknown = sorted(set(recipe) - set(SITES))
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {unknown} — see "
                f"znicz_tpu_torch.resilience.faults.SITES")
        self._specs = {site: _normalize(site, spec)
                       for site, spec in recipe.items()}
        self._lock = threading.Lock()
        self._arrivals: dict[str, int] = {}
        self._events: dict[str, int] = {}
        self._rngs: dict[str, np.random.Generator] = {}

    # ------------------------------------------------------------------
    def _rng(self, site: str) -> np.random.Generator:
        gen = self._rngs.get(site)
        if gen is None:
            key = np.array([self.seed & ((1 << 64) - 1),
                            zlib.crc32(site.encode())], dtype=np.uint64)
            gen = self._rngs[site] = np.random.Generator(
                np.random.Philox(key=key))
        return gen

    def fire(self, site: str, **ctx):
        """One arrival at ``site``: the payload dict when the plan says
        this arrival faults, else ``None``."""
        spec = self._specs.get(site)
        if spec is None:
            return None
        with self._lock:
            for key, want in spec.items():
                if key in _CONTROL_KEYS:
                    continue
                if key in ctx and ctx[key] != want:
                    return None  # context mismatch: not our arrival
            n = self._arrivals.get(site, 0) + 1
            self._arrivals[site] = n
            fired = event = False
            if "at" in spec:
                fired = event = n in set(int(a) for a in spec["at"])
            elif "after" in spec:
                fired = n >= int(spec["after"])
                # a persistent fault is ONE event however often it is
                # observed (one corrupt shard, many reads of it)
                event = fired and not self._events.get(site)
            elif "p" in spec:
                fired = event = bool(
                    self._rng(site).random() < float(spec["p"]))
            if not fired:
                return None
            if event:
                self._events[site] = self._events.get(site, 0) + 1
                _metrics.faults_injected(site).inc()
        payload = {k: v for k, v in spec.items() if k not in _CONTROL_KEYS}
        payload.update(ctx)
        payload["site"] = site
        payload["arrival"] = n
        return payload

    # ------------------------------------------------------------------
    @property
    def events_fired(self) -> int:
        """Distinct fault events fired so far (what the dryrun tail
        attests as ``faults_injected``)."""
        with self._lock:
            return sum(self._events.values())

    def counts(self) -> dict:
        with self._lock:
            return dict(self._events)

    def configured_sites(self) -> set:
        return set(self._specs)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, sites={sorted(self._specs)})"


# ----------------------------------------------------------------------
# the module-level gate every injection point calls
# ----------------------------------------------------------------------
def active() -> FaultPlan | None:
    """The configured plan, or None (the fast path: one dict lookup).
    A plain dict recipe in ``root.common.engine.faults`` is wrapped
    into a :class:`FaultPlan` on first touch and stored back, so its
    arrival counters persist for the run."""
    plan = root.common.engine.get("faults", None)
    if plan is None or plan is False:
        return None
    if not isinstance(plan, FaultPlan):
        if hasattr(plan, "as_dict"):  # the config tree nodified the
            plan = plan.as_dict()     # recipe dict on assignment
        plan = FaultPlan(plan)
        root.common.engine.faults = plan
    return plan


def fire(site: str, **ctx):
    """Arrival at a named site: payload dict when it faults, else
    None.  Zero work when no plan is configured."""
    plan = active()
    if plan is None:
        return None
    return plan.fire(site, **ctx)


def site_configured(*sites: str) -> bool:
    """True when the active plan injects at ANY of the given sites —
    lets initialize-time code (the guard's inject leaf) avoid touching
    the traced program when no training fault can ever fire."""
    plan = active()
    return plan is not None and bool(
        plan.configured_sites() & set(sites))
