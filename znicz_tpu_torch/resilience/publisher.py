"""Train-to-serve publication: the bundle publisher, the watcher, the
canary gate and the rollback (port of
``znicz_tpu/resilience/publisher.py``).

The reference's control plane of the train-to-serve loop, over the
port's export and its engines' recapture-free ``swap_weights``
(:meth:`ServingEngine.swap_weights
<znicz_tpu_torch.serving.engine.ServingEngine.swap_weights>`,
:meth:`DecodeEngine.swap_weights
<znicz_tpu_torch.serving.decode.DecodeEngine.swap_weights>`: the
weights copied into the tensors the CUDA graphs read):

- **publication** (the training side): :func:`publish_bundle` and
  :class:`WeightPublisher` export the forward chain into a handoff
  directory as ``<prefix>_v<version>.npz`` beside a ``.sha256``
  sidecar, versions strictly rising, each write atomic (a temporary
  file and a rename, the sidecar last), and only process 0 of a run
  writes (the others fence on the new version's sidecar,
  :func:`_fence_publish`); ``quantize="int8"`` rewrites the staged
  bundle through :mod:`~znicz_tpu_torch.serving.quantize` behind its
  accuracy gate.  The reference also packs its compiled serving
  programs beside the weights; the port has no program cache yet
  (ROADMAP A12), so it packs none, and the manifest's
  ``aot_programs`` says so;
- **watching** (the serving side): :class:`PublicationWatcher` loads
  only bundles whose digest checks, falls back to the newest older good
  version when the latest is corrupt, and never retries a bad one;
- **canary and rollback**: :class:`SwapController` scores a candidate
  with a shadow evaluator (:func:`classifier_score`, the numpy oracle
  on a held-out stream, so a canary adds no CUDA graph), rejects one
  that regresses past ``engine.swap_guard_margin``, promotes the rest
  with ``swap_weights`` and keeps each on probation for
  ``engine.swap_probation_steps`` served requests, swapping straight
  back to the prior version when the engine turns unhealthy.

Every verdict is a registry series (``znicz_swaps_total{outcome}``,
``znicz_model_version``, ``znicz_publishes_total``,
``znicz_snapshot_age_seconds``).  Drill sites: ``publish.corrupt``,
``swap.canary_regress`` and ``swap.probation_fail``.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.units import Unit
from znicz_tpu_torch.utils.config import register_defaults, root
from znicz_tpu_torch.utils.logger import Logger

register_defaults("common", {"engine": {
    "swap_guard_margin": 0.02, "swap_probation_steps": 50,
    "publish_fence_timeout_s": 60.0}})

# the snapshotter imports this package (faults), so its digest helpers
# are imported inside the functions here

__all__ = ["publish_bundle", "published_versions", "PublicationWatcher",
           "SwapController", "WeightPublisher", "classifier_score",
           "mark_artifact_written"]

#: what a published manifest's ``aot_programs`` says: the port has no
#: program cache to pack from yet
AOT_PROGRAMS = "none: the port has no AOT program cache yet (ROADMAP A12)"

#: ``<prefix>_v<version>.npz`` — the publication naming contract
_VERSION_RE = re.compile(r"_v(\d+)\.npz$")

#: last-good artifact timestamps feeding znicz_snapshot_age_seconds
#: (a live callback gauge: /readyz sees a stalled trainer as growing
#: age without any writer-side heartbeat)
_last_written: dict[str, float] = {}


def mark_artifact_written(source: str) -> None:
    """Record a good artifact write for ``source`` and keep its
    ``znicz_snapshot_age_seconds`` child live (the Snapshotter and the
    publisher both report through this)."""
    _last_written[source] = time.time()
    _metrics.snapshot_age_seconds(source).set_function(
        lambda s=source: time.time() - _last_written[s])


def published_versions(directory: str,
                       prefix: str = "model") -> list[tuple[int, str]]:
    """All published ``(version, path)`` pairs in ``directory``,
    ascending — including files that may fail digest verification
    (version allocation must see them, the watcher filters them)."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        if not name.startswith(f"{prefix}_v"):
            continue
        m = _VERSION_RE.search(name)
        if m:
            out.append((int(m.group(1)),
                        os.path.join(directory, name)))
    out.sort()
    return out


def _fence_publish(directory: str, prefix: str,
                   entry: list[tuple[int, str]]) -> tuple[int, str]:
    """Non-master half of a lockstep multi-process publish: wait for
    process 0's new version to land COMPLETE (its ``.sha256`` sidecar
    exists — the sidecar is written strictly after the atomic data
    replace).  ``entry`` is the version listing at call entry; the
    fence is satisfied by any complete version newer than the newest
    complete one at entry, or by the entry-newest itself when its
    sidecar is FRESH (process 0 finished before this process arrived
    at the lockstep site).  Bounded by
    ``engine.publish_fence_timeout_s`` (default 60 s); on timeout the
    newest complete version is returned with a warning rather than
    stranding the gang."""
    import logging
    import time as _time

    log = logging.getLogger("publisher")
    entry_wall = _time.time()
    entry_complete = max(
        (v for v, p in entry if os.path.exists(f"{p}.sha256")),
        default=0)
    timeout = float(root.common.engine.get("publish_fence_timeout_s",
                                           60.0))
    deadline = _time.monotonic() + timeout

    def newest_complete() -> tuple[int, str] | None:
        done = [(v, p) for v, p in published_versions(directory, prefix)
                if os.path.exists(f"{p}.sha256")]
        return done[-1] if done else None

    while True:
        got = newest_complete()
        if got is not None:
            version, path = got
            try:
                side_mtime = os.path.getmtime(f"{path}.sha256")
            except OSError:
                side_mtime = 0.0
            if version > entry_complete \
                    or side_mtime >= entry_wall - 2.0:
                return version, path
        if _time.monotonic() >= deadline:
            if got is not None:
                log.warning(
                    "publish fence in %s timed out after %.0fs — "
                    "returning the newest complete version v%d",
                    directory, timeout, got[0])
                return got
            raise OSError(
                f"publish fence in {directory} timed out after "
                f"{timeout:.0f}s with no complete version — process 0 "
                f"never published (shared filesystem not mounted on "
                f"every host, or the master publish failed)")
        _time.sleep(0.02)


def _quantize_staged(tmp: str, mode: str, calib) -> dict:
    """Rewrite the staged (not yet visible) bundle as its int8
    twin.  The accuracy gate runs HERE, before any bytes are
    published: when the calibration stream shows the quantized numpy
    oracle regressing past ``engine.swap_guard_margin``, the f32
    bundle ships instead and the gate verdict is logged.  The
    ``quant.calib_corrupt`` chaos site fires inside
    :func:`~znicz_tpu_torch.serving.quantize.quantize_bundle` AFTER the
    gate — a mis-scaled bundle then publishes cleanly and the
    downstream canary is the only defense left, which is exactly what
    the chaos drill proves."""
    import io
    import json
    import logging

    from znicz_tpu_torch.export import read_bundle
    from znicz_tpu_torch.serving import quantize as _quant
    if mode != "int8":
        raise ValueError(f"unsupported quantize mode {mode!r}")
    manifest, params = read_bundle(tmp)
    qman, qparams, info = _quant.quantize_bundle(manifest, params,
                                                 calib=calib)
    if not info.get("quantized"):
        return info
    margin = float(root.common.engine.get("swap_guard_margin", 0.02))
    delta = info.get("acc_delta")
    if delta is not None and delta > margin \
            and not info.get("corrupted"):
        logging.getLogger("publisher").warning(
            "int8 calibration regressed %.4f > guard margin %.4f — "
            "publishing the f32 bundle instead", delta, margin)
        info["gated"] = True
        return info
    arrays = {k: np.asarray(v) for k, v in qparams.items()}
    arrays["manifest"] = np.frombuffer(
        json.dumps(qman).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    info["gated"] = False
    return info


def publish_bundle(workflow, directory: str,
                   prefix: str = "model", *,
                   quantize: str | None = None,
                   calib: tuple | None = None) -> tuple[int, str]:
    """Export ``workflow``'s trained forward chain into the handoff
    directory as the next monotonic version, with a sha256 sidecar.

    Write order is crash-safe and reader-safe: the bundle is exported
    to a temp name, its digest computed, then atomically renamed into
    place BEFORE the sidecar lands — a watcher polling mid-publish
    sees either nothing or a complete file (a missing sidecar just
    defers pickup to the next poll).  The ``publish.corrupt`` chaos
    site flips bytes AFTER the digest is computed, producing exactly
    the torn-publish failure the watcher must reject.

    ``quantize="int8"`` rewrites the staged bundle as its
    per-channel int8 twin before the digest; ``calib=(x, y)`` is the
    canary/shadow stream the accuracy gate scores both arms on — a
    regression past ``engine.swap_guard_margin`` ships the f32 bundle
    instead."""
    from znicz_tpu_torch.export import export_forward
    from znicz_tpu_torch.parallel.distributed import process_info
    from znicz_tpu_torch.utils.snapshotter import _sha256_file
    os.makedirs(directory, exist_ok=True)
    existing = published_versions(directory, prefix)
    pidx, pcount = process_info()
    if pcount > 1 and pidx != 0:
        # only process 0 writes shared publish artifacts —
        # the rest fence on the new version's digest sidecar appearing
        return _fence_publish(directory, prefix, existing)
    version = (existing[-1][0] + 1) if existing else 1
    final = os.path.join(directory, f"{prefix}_v{version:06d}.npz")
    tmp = f"{final}.{os.getpid()}.staging"
    with _tracing.TRACER.span("publish_bundle", cat="snapshot",
                              version=version):
        export_forward(workflow, tmp, extra={"aot_programs": AOT_PROGRAMS})
        if quantize is not None:
            _quantize_staged(tmp, quantize, calib)
        digest = _sha256_file(tmp)
        if _faults.fire("publish.corrupt") is not None:
            with open(tmp, "r+b") as f:  # digest now lies about this
                f.seek(max(0, os.path.getsize(tmp) // 2))
                f.write(b"\xde\xad\xbe\xef")
        os.replace(tmp, final)
        side_tmp = f"{final}.sha256.{os.getpid()}.tmp"
        with open(side_tmp, "w") as f:
            f.write(digest + "\n")
        os.replace(side_tmp, f"{final}.sha256")
    source = f"publish:{prefix}"
    _metrics.publishes_total(source).inc()
    mark_artifact_written(source)
    return version, final


class PublicationWatcher(Logger):
    """Serving-side poller over a publication directory.

    :meth:`poll` surfaces the newest digest-verified bundle whose
    version exceeds everything seen so far, as ``(version, path,
    manifest, params)`` — or ``None`` when nothing new verifies.  A
    corrupt newest falls back to the newest OLDER good version
    (counted as ``znicz_snapshot_failures_total{op=publish}`` +
    ``znicz_recoveries_total{kind=publish_fallback}``); corrupt or
    rejected versions are quarantined and never retried."""

    def __init__(self, directory: str, prefix: str = "model") -> None:
        super().__init__()
        self.directory = directory
        self.prefix = prefix
        self.version = 0      # newest version surfaced so far
        self._bad: set[int] = set()

    def mark_bad(self, version: int) -> None:
        """Quarantine a version (the controller calls this for canary
        rejections and probation rollbacks so a bad model is never
        re-promoted)."""
        self._bad.add(int(version))

    def _verify(self, path: str) -> None:
        from znicz_tpu_torch.utils.snapshotter import (SnapshotCorrupt,
                                                       _sha256_file)
        sidecar = f"{path}.sha256"
        if not os.path.exists(sidecar):
            raise SnapshotCorrupt(
                f"{path}: published bundle has no sha256 sidecar "
                f"(incomplete publish?)")
        with open(sidecar) as f:
            want = f.read().strip()
        got = _sha256_file(path)
        if got != want:
            raise SnapshotCorrupt(
                f"{path}: sha256 {got[:12]}… != sidecar {want[:12]}…")

    def poll(self):
        """Newest unseen good bundle, or ``None``."""
        from znicz_tpu_torch.export import read_bundle
        fell_back = False
        for version, path in sorted(
                published_versions(self.directory, self.prefix),
                reverse=True):
            if version <= self.version:
                break  # older than what we already surfaced
            if version in self._bad:
                continue  # quarantined; an older unseen may still do
            try:
                self._verify(path)
                manifest, params = read_bundle(path)
            except Exception as exc:  # noqa: BLE001 — corrupt publish
                _metrics.snapshot_failures("publish").inc()
                self._bad.add(version)
                fell_back = True
                self.warning("published bundle rejected: %s", exc)
                continue  # fall back to the next older version
            self.version = version
            if fell_back:
                _metrics.recoveries("publish_fallback").inc()
            return version, path, manifest, params
        return None


def classifier_score(x, y):
    """A shadow-evaluator ``score_fn(manifest, params) -> accuracy``
    over a held-out stream, running the numpy oracle — canary scoring
    must never add a CUDA graph to the serving engine, so the candidate
    is rebuilt on the host path.  Works
    for one-shot classifiers and next-token LM bundles alike (the
    export chain ends in a softmax head either way)."""
    x = np.asarray(x)
    y = np.asarray(y)

    def score(manifest: dict, params: dict) -> float:
        from znicz_tpu_torch.export import ExportedModel
        model = ExportedModel(dict(manifest), dict(params),
                              device="numpy")
        return float((model.predict_classes(x) == y).mean())

    return score


class SwapController(Logger):
    """The promote/reject/rollback state machine over one engine.

    Drive it with :meth:`tick` from any host loop (the soak bench
    ticks between replay submits; the dryrun ticks between waves).
    Each tick first settles probation, then — when no probation is
    active — polls the watcher and runs one candidate through
    canary → promote.

    ``score_fn(manifest, params) -> float`` (higher is better) is the
    shadow evaluator; ``None`` disables the canary gate (every good
    publish promotes).  ``guard_margin`` / ``probation_steps`` default
    to ``engine.swap_guard_margin`` (0.02) /
    ``engine.swap_probation_steps`` (50 served requests)."""

    def __init__(self, engine, watcher: PublicationWatcher,
                 score_fn=None, *, guard_margin: float | None = None,
                 probation_steps: int | None = None) -> None:
        super().__init__()
        self.engine = engine
        self.watcher = watcher
        self.score_fn = score_fn
        self.guard_margin = float(
            root.common.engine.get("swap_guard_margin", 0.02)
            if guard_margin is None else guard_margin)
        self.probation_steps = int(
            root.common.engine.get("swap_probation_steps", 50)
            if probation_steps is None else probation_steps)
        #: the serving truth: what the engine is running right now
        self._incumbent: dict | None = None
        self._probation: dict | None = None

    # ------------------------------------------------------------------
    def _served(self) -> int:
        return int(self.engine.stats()["served"])

    def _ensure_incumbent(self) -> dict:
        if self._incumbent is None:
            manifest, params = self.engine.current_bundle()
            self._incumbent = {"version": self.engine.model_version,
                               "manifest": manifest, "params": params,
                               "score": None}
        return self._incumbent

    def _score(self, manifest, params) -> float | None:
        if self.score_fn is None:
            return None
        return float(self.score_fn(manifest, params))

    @property
    def on_probation(self) -> bool:
        return self._probation is not None

    def _quant_outcome(self, manifest, outcome: str) -> None:
        """Quantized candidates get their own canary ledger
        (``znicz_quant_canary_total{outcome}``) — the quant
        dryrun and the fleet dashboards watch the int8 promote/reject
        ratio separately from ordinary weight refreshes."""
        if manifest and manifest.get("quant"):
            _metrics.quant_canary(
                getattr(self.engine, "_obs_id", "engine"),
                outcome).inc()

    # ------------------------------------------------------------------
    def tick(self) -> list[str]:
        """One control-plane step; returns human-readable events."""
        events: list[str] = []
        self._check_probation(events)
        if self._probation is None:
            got = self.watcher.poll()
            if got is not None:
                self._consider(*got, events=events)
        return events

    def _consider(self, version: int, path: str, manifest: dict,
                  params: dict, events: list[str]) -> None:
        from znicz_tpu_torch.export import SwapIncompatible
        incumbent = self._ensure_incumbent()
        cand_score = self._score(manifest, params)
        if cand_score is not None:
            payload = _faults.fire("swap.canary_regress")
            if payload is not None:
                cand_score -= float(payload.get("penalty", 1.0))
            if incumbent["score"] is None:
                incumbent["score"] = self._score(
                    incumbent["manifest"], incumbent["params"])
            if cand_score < incumbent["score"] - self.guard_margin:
                self.engine.record_swap_outcome("rejected")
                self._quant_outcome(manifest, "rejected")
                self.watcher.mark_bad(version)
                msg = (f"rejected v{version}: canary "
                       f"{cand_score:.4f} < incumbent "
                       f"{incumbent['score']:.4f} − margin "
                       f"{self.guard_margin}")
                self.warning(msg)
                events.append(msg)
                return
        try:
            self.engine.swap_weights((manifest, params),
                                     version=version)
        except SwapIncompatible as exc:
            self.engine.record_swap_outcome("rejected")
            self._quant_outcome(manifest, "rejected")
            self.watcher.mark_bad(version)
            msg = f"rejected v{version}: {exc}"
            self.warning(msg)
            events.append(msg)
            return
        self._quant_outcome(manifest, "promoted")
        self._incumbent = {"version": version, "manifest": manifest,
                           "params": params, "score": cand_score}
        self._probation = {"prior": incumbent, "version": version,
                           "until": self._served()
                           + self.probation_steps,
                           "t0": time.monotonic()}
        events.append(f"promoted v{version} (probation for "
                      f"{self.probation_steps} served requests)")

    def _check_probation(self, events: list[str]) -> None:
        p = self._probation
        if p is None:
            return
        unhealthy = _faults.fire("swap.probation_fail") is not None
        if not unhealthy:
            # the breaker IS the health signal: a model whose
            # dispatches fail (or stall the queue) opens it within
            # the probation window
            unhealthy = getattr(self.engine, "breaker_state",
                                "closed") == "open" \
                or not self.engine.ready()
        if unhealthy:
            prior = p["prior"]
            self.engine.swap_weights(
                (prior["manifest"], prior["params"]),
                version=prior["version"], outcome="rolled_back")
            self.watcher.mark_bad(p["version"])
            if self._incumbent is not None:
                self._quant_outcome(self._incumbent["manifest"],
                                    "rolled_back")
            self._incumbent = prior
            self._probation = None
            msg = (f"rolled back v{p['version']} → "
                   f"v{prior['version']} (probation tripped)")
            self.warning(msg)
            events.append(msg)
            return
        if self._served() >= p["until"]:
            self._probation = None
            events.append(f"v{p['version']} passed probation")


class WeightPublisher(Unit):
    """Epoch side-chain unit: publish the forward chain every N epochs
    (wire with ``StandardWorkflow.link_weight_publisher`` — it rides
    the decision's ``epoch_ended`` gate exactly like the snapshotter
    rides ``improved``).  This is the training half of the continuous
    soak loop: train → publish → the serving process's watcher picks
    it up → canary → hot swap, all while requests keep flowing."""

    def __init__(self, workflow, name: str | None = None,
                 directory: str | None = None, prefix: str = "model",
                 every_n_epochs: int = 1,
                 quantize: str | None = None,
                 calib: tuple | None = None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.directory = directory or os.path.join(
            str(root.common.dirs.snapshots), "published")
        self.prefix = prefix
        self.every = max(1, int(every_n_epochs))
        self.quantize = quantize
        self.calib = calib
        self._epochs = 0
        self.published: list[tuple[int, str]] = []

    def run(self) -> None:
        self._epochs += 1
        if self._epochs % self.every:
            return
        from znicz_tpu_torch.parallel.distributed import process_info
        pidx, pcount = process_info()
        if pcount > 1 and pidx != 0:
            # single-writer discipline (the handoff directory is
            # shared); parameter reads here are replicated leaves, so
            # non-master processes can simply skip
            return
        version, path = publish_bundle(self.workflow, self.directory,
                                       self.prefix,
                                       quantize=self.quantize,
                                       calib=self.calib)
        self.published.append((version, path))
        self.info("published model v%d → %s", version, path)
