"""Silent-data-corruption sentinel: fingerprints, audits, quarantine
(port of ``znicz_tpu/resilience/integrity.py``).

The guard (:mod:`~znicz_tpu_torch.resilience.guard`) catches loud
failures, a non-finite loss or gradient.  A card that computes finite
but wrong values trips none of the other defenses; this module is the
detection layer for it, as in the reference:

- **Step fingerprints.**  Every weighted backward unit folds a cheap
  sub-sampled checksum (:func:`tensor_fingerprint`) of each parameter
  it updates into the guard's ``sdc_fingerprint`` (f32[5]): slot 2 the
  stored value before the update, slot 1 the gradient it applies, slot
  0 the committed value.  The folds run inside the training step (on
  the card, inside its CUDA graph): a sample plan per tensor (the
  flat positions ``0, s, 2s, …`` of the logical tensor, ``s = max(1,
  n // 64)``, each weighted ``1 + (k mod 31)``) is built once on the
  host and kept on the device, so the fold is one gather, one product
  and one sum.  A tensor this process holds only a block of (a
  tensor-parallel parameter, a ZeRO-1 gradient shard) folds the
  samples that fall in its block, by their logical positions, and the
  partial sums are summed over the axes that split it, so every
  fingerprint is the reference's fold of the logical tensor, whatever
  the placement.  The guard keeps the sticky self-check (slot 3) and
  the previous claimed value (slot 4).
- **Cross-replica vote.**  At ``engine.sdc_vote_interval`` steps the
  sentinel gathers ``(claimed device fp, host recompute, sticky
  count)`` from every process (an all-gather over the world group:
  gloo on the CPU, NCCL with CUDA tensors on the card) and
  :func:`vote_verdict` names the culprits.
- **Redundant-compute audit.**  At ``engine.sdc_audit_interval`` steps
  (0, off, by default) the state before a step is kept, the step runs
  on the device, then the same step runs on a numpy-oracle clone
  (:meth:`StandardWorkflow.build_shadow`, the numpy oracle of
  :class:`~znicz_tpu_torch.backends.NumpyDevice`) and the per-tensor
  fingerprints after it are compared within ``engine.sdc_audit_rtol``.
- **Quarantine.**  Under an elastic gang a confirmed culprit annotates
  the heartbeat channel and exits
  :data:`~znicz_tpu_torch.resilience.supervisor.EXIT_SDC` (its peers
  :data:`~znicz_tpu_torch.resilience.supervisor.EXIT_PEER_LOST`); a run
  without one rolls back in-process to the last snapshot a clean vote
  saw.

Gate: ``root.common.engine.sdc_fingerprints`` (on by default, wherever
the guard is on).  Knobs, at the reference's defaults:
``sdc_vote_interval`` (50), ``sdc_audit_interval`` (0),
``sdc_suspect_threshold`` (1), ``sdc_fp_rtol`` and ``sdc_audit_rtol``
(1e-3).  Drill sites: ``sdc.flip_param`` and ``sdc.flip_grad``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.utils.config import register_defaults, root
from znicz_tpu_torch.utils.logger import Logger

register_defaults("common", {"engine": {
    "sdc_fingerprints": True, "sdc_vote_interval": 50,
    "sdc_audit_interval": 0, "sdc_suspect_threshold": 1,
    "sdc_fp_rtol": 1e-3, "sdc_audit_rtol": 1e-3}})

#: the sdc injection sites the guard's device leaf hosts
SDC_TRAIN_SITES = ("sdc.flip_param", "sdc.flip_grad")

#: elements sampled per tensor by the fingerprint
FP_SAMPLES = 64


def enabled() -> bool:
    """``engine.sdc_fingerprints`` (default on)."""
    return bool(root.common.engine.get("sdc_fingerprints", True))


def tensor_fingerprint(arr) -> np.float32:
    """Position-weighted sub-sampled checksum of one array (the
    reference's ``tensor_fingerprint`` with numpy, copied): about
    :data:`FP_SAMPLES` elements at a fixed stride, element 0 always
    among them, weighted ``1 + (k mod 31)`` so that swapped values do
    not cancel; f32 math."""
    flat = np.ravel(np.asarray(arr)).astype(np.float32)
    n = int(flat.shape[0])
    stride = max(1, n // FP_SAMPLES)
    sample = flat[::stride]
    weights = 1.0 + (np.arange(sample.shape[0], dtype=np.float32) % 31.0)
    return np.sum(sample * weights)


def sample_plan(shape, cuts=()) -> tuple[tuple, np.ndarray]:
    """The samples of :func:`tensor_fingerprint` over the logical tensor
    of ``shape`` that fall in this process's block: ``(index, weights)``
    where ``index`` is a tuple of per-dim local index arrays.  ``cuts``
    are the narrowings that lead from the logical tensor to the block,
    in order, as ``(dim, parts, index, pad)``: the dim zero-padded by
    ``pad``, split in ``parts`` blocks, block ``index`` kept (the
    padding is never sampled)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape)) if shape else 1
    stride = max(1, n // FP_SAMPLES)
    pos = np.arange(0, n, stride)
    weights = (1.0 + (np.arange(pos.shape[0]) % 31)).astype(np.float32)
    multi = np.unravel_index(pos, shape) if shape else ()
    offset = [0] * len(shape)
    valid = list(shape)    # the real (unpadded) elements of the view
    extent = list(shape)   # the view's length, its padding included
    for dim, parts, index, pad in cuts:
        block = (extent[dim] + pad) // parts
        start = index * block
        offset[dim] += start
        valid[dim] = max(0, min(block, valid[dim] - start))
        extent[dim] = block
    keep = np.ones(pos.shape[0], dtype=bool)
    local = []
    for d in range(len(shape)):
        rel = multi[d] - offset[d]
        keep &= (rel >= 0) & (rel < valid[d])
        local.append(rel)
    return tuple(r[keep] for r in local), weights[keep]


#: (logical shape, cuts, device) → the sample plan as device tensors
_PLANS: dict = {}


def cuts_of(resolved, mesh) -> tuple[tuple, tuple]:
    """``(cuts, groups)`` of a placement on ``mesh``: the narrowings of
    :func:`sample_plan` that lead to this process's block, and the
    process groups of the axes that split it (both empty when this
    process holds the whole tensor)."""
    from znicz_tpu_torch.parallel.partition import _sharded_dims
    if resolved is None or mesh is None:
        return (), ()
    dims = _sharded_dims(resolved, mesh)
    return (tuple((dim, mesh.size(axis), mesh.index(axis), pad)
                  for dim, axis, pad in dims),
            tuple(mesh.group(axis) for _, axis, _ in dims))


def fingerprint_partial(t: torch.Tensor, logical_shape=None,
                        cuts=()) -> torch.Tensor:
    """:func:`tensor_fingerprint` of the logical tensor, over the part
    of it that ``t`` (this process's block, cut by ``cuts``) holds: a
    0-d f32 device tensor, no host sync.  The plan's index and weight
    tensors are made on the first call (a capture replays them)."""
    shape = tuple(t.shape) if logical_shape is None else tuple(
        logical_shape)
    index, weights = device_plan(shape, tuple(cuts), t.device)
    return torch.sum(t[index].float() * weights)


def device_plan(shape: tuple, cuts: tuple, device) -> tuple:
    """:func:`sample_plan` as device tensors ``(index, weights)``, made
    once a key."""
    key = (shape, cuts, str(device))
    plan = _PLANS.get(key)
    if plan is None:
        index, weights = sample_plan(shape, cuts)
        plan = _PLANS[key] = (
            tuple(torch.as_tensor(i, dtype=torch.long, device=device)
                  for i in index),
            torch.as_tensor(weights, device=device))
    return plan


def holds_origin(cuts) -> bool:
    """True when this process's block holds the logical element 0 (the
    target of ``sdc.flip_grad``)."""
    return all(index == 0 for _, _, index, _ in cuts)


def host_fingerprint(t: torch.Tensor) -> float:
    """:func:`tensor_fingerprint` of the tensor ``t`` computed on the
    host: only its sampled elements cross (a gather on the device, then
    a small copy), and the weighted sum is numpy's, so it is
    :func:`tensor_fingerprint` of the whole array bit for bit."""
    index, weights = device_plan(tuple(t.shape), (), t.device)
    sample = t.detach()[index].to("cpu", torch.float32).numpy()
    return float(np.sum(sample * weights.cpu().numpy()))


def _logical_params(workflow):
    """``(label, logical tensor)`` of every parameter the fingerprint
    fold covers, in fold order (a sharded one gathered: a collective,
    so every process of the run calls this in lockstep)."""
    for gd_unit in getattr(workflow, "gds", ()):
        for label, (fwd, attr) in getattr(gd_unit, "_fp_folded",
                                          {}).items():
            t = getattr(fwd, attr)
            yield label, fwd.full_tensor(attr, t)


def host_param_fingerprint(workflow) -> float:
    """The parameter fingerprint recomputed on the host from the same
    tensors the device fold covered, in the same order (an f64 sum of
    the per-tensor f32 folds)."""
    return float(sum(host_fingerprint(t)
                     for _, t in _logical_params(workflow)))


def audit_fingerprints(workflow) -> list[tuple[str, float]]:
    """Per-tensor host fingerprints ``[(label, fp)]`` of every parameter
    the device fold covers, labelled ``<forward unit>.<attribute>``."""
    return [(label, host_fingerprint(t))
            for label, t in _logical_params(workflow)]


def _rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def vote_verdict(device_fps, host_fps, rtol: float,
                 self_flags=None) -> dict:
    """The verdict over the gathered fingerprint evidence (the
    reference's, copied): ``device_fps[p]`` is process p's claimed fold,
    ``host_fps[p]`` its host recompute, ``self_flags[p]`` its guard's
    sticky self-check count.  Returns ``{"divergent", "culprits",
    "self_bad"}``: a process whose sticky count is up or whose claimed
    fold disagrees with its own recompute is a culprit on its own;
    otherwise the minority cluster of host fingerprints is (a tie
    suspects every process)."""
    device_fps = [float(v) for v in device_fps]
    host_fps = [float(v) for v in host_fps]
    n = len(device_fps)
    flags = ([float(v) for v in self_flags]
             if self_flags is not None else [0.0] * n)
    divergent = any(_rel_diff(host_fps[0], v) > rtol
                    for v in host_fps[1:])
    self_bad = [p for p in range(n)
                if flags[p] > 0.0
                or _rel_diff(device_fps[p], host_fps[p]) > rtol]
    if not divergent and not self_bad:
        return {"divergent": False, "culprits": [], "self_bad": []}
    if self_bad:
        return {"divergent": True, "culprits": sorted(self_bad),
                "self_bad": sorted(self_bad)}
    clusters: list[list[int]] = []
    for p, v in enumerate(host_fps):
        for cluster in clusters:
            if _rel_diff(host_fps[cluster[0]], v) <= rtol:
                cluster.append(p)
                break
        else:
            clusters.append([p])
    biggest = max(len(c) for c in clusters)
    majority = [c for c in clusters if len(c) == biggest]
    if len(majority) == 1 and biggest > n - biggest:
        culprits = sorted(p for c in clusters if c is not majority[0]
                          for p in c)
    else:  # a tie: every process is suspect
        culprits = list(range(n))
    return {"divergent": True, "culprits": culprits, "self_bad": []}


class IntegritySentinel(Logger):
    """The host-side driver of the SDC detectors of one training
    workflow, ticked by the decision at every step boundary
    (:meth:`on_step`): every process ticks in lockstep, so the vote's
    all-gather is a legal collective."""

    def __init__(self, workflow, **overrides) -> None:
        super().__init__()
        engine = root.common.engine
        self.workflow = workflow
        self.vote_interval = int(overrides.get(
            "vote_interval", engine.get("sdc_vote_interval", 50)))
        self.audit_interval = int(overrides.get(
            "audit_interval", engine.get("sdc_audit_interval", 0)))
        self.suspect_threshold = int(overrides.get(
            "suspect_threshold", engine.get("sdc_suspect_threshold", 1)))
        self.fp_rtol = float(overrides.get(
            "fp_rtol", engine.get("sdc_fp_rtol", 1e-3)))
        self.audit_rtol = float(overrides.get(
            "audit_rtol", engine.get("sdc_audit_rtol", 1e-3)))
        self._tick = 0
        self._suspect_streak: dict[int, int] = {}
        self._audit_streak = 0
        #: the newest snapshot a clean vote saw: the quarantine's target
        self.last_good_snapshot: str | None = None
        self._pending_audit_state: dict | None = None
        self._shadow = None
        self.quarantined = False

    def read_device_fingerprint(self) -> np.ndarray | None:
        """The guard's f32[5] fingerprint state (one small read), or
        None without a guard."""
        guard = getattr(self.workflow, "anomaly_guard", None)
        if guard is None:
            return None
        return guard.read_sdc_fingerprint()

    # -- the per-step tick ---------------------------------------------------
    def on_step(self) -> None:
        if self.quarantined:
            return
        self._tick += 1
        if self.audit_interval > 0:
            if self._pending_audit_state is not None:
                self._run_audit()
            elif (self._tick + 1) % self.audit_interval == 0:
                # the next step is the audit's: keep the state before it
                self._capture_audit_state()
        if self.vote_interval > 0 and self._tick % self.vote_interval == 0:
            self._vote()

    # -- the cross-replica vote ---------------------------------------------
    def _vote(self) -> None:
        from znicz_tpu_torch.parallel.distributed import process_info
        from znicz_tpu_torch.parallel.process_shard import _exact_allgather
        wf = self.workflow
        fp = self.read_device_fingerprint()
        if fp is None or fp[0] == 0.0:
            return  # no train step folded yet
        _, pcount = process_info()
        host_fp = host_param_fingerprint(wf)
        triple = [fp[0], host_fp, fp[3]]  # claimed, recomputed, sticky
        if pcount == 1:
            verdict = vote_verdict([triple[0]], [triple[1]], self.fp_rtol,
                                   self_flags=[triple[2]])
        else:
            gathered = _exact_allgather(np.asarray(triple,
                                                   dtype=np.float64))
            verdict = vote_verdict(gathered[:, 0], gathered[:, 1],
                                   self.fp_rtol, self_flags=gathered[:, 2])
        self.last_verdict = verdict
        if not verdict["divergent"]:
            _metrics.sdc_votes(wf.name, "clean").inc()
            self._suspect_streak.clear()
            snap = getattr(wf, "snapshotter", None)
            dest = getattr(snap, "destination", None)
            if dest and os.path.exists(dest):
                self.last_good_snapshot = dest
            return
        _metrics.sdc_votes(wf.name, "divergent").inc()
        _metrics.sdc_detected("vote").inc()
        for p in verdict["culprits"]:
            _metrics.sdc_suspects(p, "-").inc()
            self._suspect_streak[p] = self._suspect_streak.get(p, 0) + 1
        self.warning(
            "SDC vote divergent at tick %d: culprits=%s (self-evident=%s, "
            "last good=%s)", self._tick, verdict["culprits"],
            verdict["self_bad"], self.last_good_snapshot)
        confirmed = [p for p, s in self._suspect_streak.items()
                     if s >= self.suspect_threshold]
        if confirmed:
            self._quarantine(confirmed, detector="vote")

    # -- the redundant-compute audit -----------------------------------------
    def _shadow_workflow(self):
        if self._shadow is None:
            self._shadow = self.workflow.build_shadow()
        return self._shadow

    def _capture_audit_state(self) -> None:
        from znicz_tpu_torch.parallel.distributed import process_info
        if process_info()[1] > 1:
            # several processes would each replay their block of the
            # step; the vote is the detector across processes
            return
        self._pending_audit_state = self.workflow.state_dict()

    def _run_audit(self) -> None:
        """Replay the step that just ran on the device from the state
        kept before it, on the numpy-oracle shadow, and compare the
        per-tensor fingerprints after it."""
        from znicz_tpu_torch.utils import prng
        wf = self.workflow
        state = self._pending_audit_state
        self._pending_audit_state = None
        saved = prng.get().get_state()
        try:
            # the shadow must not move the live run's generator
            shadow = self._shadow_workflow()
            shadow.load_state(state)
            shadow.loader.run()
            for unit in shadow.hot_chain_units()[1:]:
                if not unit.gate_block and not unit.gate_skip:
                    unit.run()
            shadow_fps = dict(audit_fingerprints(shadow))
        finally:
            prng.get().set_state(saved)
        mismatched = []
        for name, dev_fp in audit_fingerprints(wf):
            ref = shadow_fps.get(name)
            if ref is not None and _rel_diff(dev_fp, ref) > self.audit_rtol:
                mismatched.append((name, dev_fp, ref))
        self.last_audit = mismatched
        if not mismatched:
            _metrics.sdc_audits(wf.name, "match").inc()
            self._audit_streak = 0
            return
        from znicz_tpu_torch.parallel.distributed import process_info
        _metrics.sdc_audits(wf.name, "mismatch").inc()
        _metrics.sdc_detected("audit").inc()
        pidx = process_info()[0]
        _metrics.sdc_suspects(pidx, "-").inc()
        self._audit_streak += 1
        self.warning(
            "SDC audit mismatch at tick %d: the device's step differs from "
            "the shadow oracle's on %s", self._tick,
            [(n, f"{d:.6g}!={r:.6g}") for n, d, r in mismatched])
        if self._audit_streak >= self.suspect_threshold:
            self._quarantine([pidx], detector="audit")

    # -- quarantine ------------------------------------------------------------
    def _quarantine(self, culprits: list[int], detector: str) -> None:
        """Under a supervised gang: annotate the heartbeat channel and
        exit (the culprit :data:`EXIT_SDC`, the others
        :data:`EXIT_PEER_LOST`).  Without one: roll back to the last
        snapshot a clean vote saw and go on."""
        from znicz_tpu_torch.observe import recorder as _recorder
        from znicz_tpu_torch.parallel.distributed import process_info
        from znicz_tpu_torch.resilience import supervisor as _sup
        wf = self.workflow
        pidx = process_info()[0]
        self.quarantined = True
        sup = getattr(wf, "_worker_supervisor", None)
        _recorder.record("sdc_quarantine", detector=detector,
                         culprits=",".join(str(c) for c in culprits),
                         process=pidx, last_good=self.last_good_snapshot)
        self.warning("SDC quarantine (%s): culprits=%s, self=%d, last "
                     "good=%s", detector, culprits, pidx,
                     self.last_good_snapshot)
        if sup is not None and getattr(sup, "writer", None) is not None:
            plan = _faults.active()
            sup.writer.annotate(
                sdc_culprits=list(culprits),
                sdc_last_good=self.last_good_snapshot,
                sdc_detected={detector: 1},
                faults_injected=(plan.counts() if plan else {}))
            os._exit(_sup.EXIT_SDC if pidx in culprits
                     else _sup.EXIT_PEER_LOST)
        _metrics.sdc_quarantined("host").inc()
        path = self.last_good_snapshot
        if path and os.path.exists(path):
            from znicz_tpu_torch.utils.snapshotter import Snapshotter
            wf.load_state(Snapshotter.load(path))
            guard = getattr(wf, "anomaly_guard", None)
            if guard is not None:
                guard.reset_sdc_fingerprint()
            _metrics.recoveries("sdc_rollback").inc()
            self.warning("rolled back to the snapshot before the "
                         "divergence, %s", path)
            self.quarantined = False
            self._audit_streak = 0
            self._suspect_streak.clear()
        else:
            self.warning("no snapshot before the divergence recorded: the "
                         "sentinel stands down (the suspect state kept)")
