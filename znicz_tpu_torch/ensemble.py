"""Ensemble: train N instances of a sample, vote with their averaged
class probabilities (port of ``znicz_tpu/ensemble.py``; the reference's
``veles/ensemble``).

Two backends, as in the reference:

- ``"process"``: the members train one after another on this process's
  device; over several processes (``torch.distributed``) process *p*
  trains members ``p::count`` and :meth:`Ensemble.evaluate` merges the
  probability sums and the member error rates with exact lockstep
  all-gathers (:mod:`~znicz_tpu_torch.parallel.process_shard`), so every
  process returns the same result;
- ``"mesh"``: all N members train together as one population
  (:class:`~znicz_tpu_torch.population.PopulationTrainer`, ``evolve=None``),
  each bit for bit the sequential run of its seed; the aggregate pass
  runs each schedule entry once for all members
  (:meth:`~znicz_tpu_torch.population.PopulationRegion.run_schedule_entry`).

The aggregate pass replays each member's validation or test minibatches
through its step (the backward units gated off on those classes,
dropout in eval mode) and averages the softmax outputs a sample.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.ops.nn_units import to_host
from znicz_tpu_torch.parallel.process_shard import (allgather_sum,
                                                    broadcast_from_zero,
                                                    merge_round_robin,
                                                    process_info)
from znicz_tpu_torch.utils.logger import Logger


def class_forward_pass(wf, klass: int) -> tuple[dict, dict]:
    """Replay every minibatch of ``klass`` through the (trained)
    workflow's step; returns ``(outputs, labels)`` keyed by global sample
    index.  A non-train class cannot train: the backward units'
    ``gate_skip`` follows ``minibatch_class != TRAIN`` and the stochastic
    units follow ``forward_mode``."""
    loader = wf.loader
    outputs: dict[int, np.ndarray] = {}
    labels: dict[int, int] = {}
    for cursor, (cls, _lo, _hi) in enumerate(loader._schedule):
        if cls != klass:
            continue
        loader._cursor = cursor
        # the device cursor follows the host's pick
        loader._sched_dirty = True
        loader.run()
        if wf._region_unit is not None:
            wf._region_unit.run()
        else:
            for unit in wf.forwards:
                unit.run()
        out = to_host(wf.forwards[-1].output)
        labs = to_host(loader.minibatch_labels)
        idx = to_host(loader.minibatch_indices)
        for row in range(loader.minibatch_size):
            gi = int(idx[row])
            outputs[gi] = np.array(out[row], copy=True)
            labels[gi] = int(labs[row])
    return outputs, labels


class Ensemble(Logger):
    """Train ``n_models`` instances of a sample and vote.

    Parameters
    ----------
    build_fn:
        ``callable(**overrides) -> StandardWorkflow`` (a sample's
        ``build``); the loss must be classification (softmax head).
    n_models / base_seed:
        member *i* trains with PRNG seed ``base_seed + i`` — different
        weight init and shuffle streams, same dataset split.
    backend:
        ``"process"`` (default — members train sequentially, or spread
        over the processes of a ``torch.distributed`` world) or
        ``"mesh"`` — all N members train together as one population
        (one step, one CUDA graph per key on the card; the member axis
        spread over ``mesh``'s data axis), each bit for bit the
        sequential run its seed would produce; the aggregate pass reads
        all N members' class probabilities from one population step.
    device_factory:
        ``callable() -> device spec`` giving where the members train
        (``"cpu"``, ``"numpy"``); None is the card, an error without
        one.
    """

    def __init__(self, build_fn: Callable, n_models: int = 3,
                 base_seed: int = 1234,
                 device_factory: Callable | None = None,
                 train_kwargs: dict | None = None,
                 backend: str = "process",
                 mesh=None) -> None:
        super().__init__()
        if n_models < 1:
            raise ValueError("n_models must be >= 1")
        if backend not in ("process", "mesh"):
            raise ValueError(f"unknown ensemble backend '{backend}'")
        self.build_fn = build_fn
        self.n_models = int(n_models)
        self.base_seed = int(base_seed)
        self.device_factory = device_factory
        self.train_kwargs = dict(train_kwargs or {})
        self.backend = backend
        self.mesh = mesh
        self.trainer = None                 # mesh backend's population
        self.workflows: list = []           # members trained locally
        self.member_ids: list[int] = []     # their GLOBAL member indices
        self.member_stats: list[dict] = []  # ALL members (gathered)

    # ------------------------------------------------------------------
    def _train_stacked(self) -> "Ensemble":
        """Mesh backend: one population run trains every member."""
        from znicz_tpu_torch.population import PopulationTrainer
        trainer = PopulationTrainer(
            self.build_fn, self.n_models,
            member_seeds=[self.base_seed + i
                          for i in range(self.n_models)],
            build_kwargs=dict(self.train_kwargs),
            mesh=self.mesh, evolve=None, name="ensemble",
            device=self._eval_device())
        trainer.initialize()
        trainer.run()
        self.trainer = trainer
        self.member_ids = list(range(self.n_models))
        self.member_stats = [
            {"seed": self.base_seed + i,
             "validation_err_pt": float(-trainer.member_best_fitness[i])}
            for i in range(self.n_models)]
        self.info("stacked ensemble trained: %s", self.member_stats)
        return self

    def _eval_device(self):
        return self.device_factory() if self.device_factory else None

    def train(self) -> "Ensemble":
        from znicz_tpu_torch.utils import prng
        if self.backend == "mesh":
            return self._train_stacked()
        pidx, pcount = process_info()
        self.workflows = []
        self.member_ids = []
        local_err_pt: list[float] = []
        local_exc: "Exception | None" = None
        for i in range(self.n_models):
            if i % pcount != pidx:
                continue
            try:
                prng.seed_all(self.base_seed + i)
                wf = self.build_fn(**self.train_kwargs)
                wf.initialize(device=self._eval_device())
                wf.run()
            except Exception as exc:
                if pcount == 1:
                    raise
                # multi-process: a lone raise would leave the peers
                # blocked in the stats-merge collective below — record
                # the failure, gather flags, raise together
                local_exc = exc
                break
            d = wf.decision
            stats = {"seed": self.base_seed + i}
            if getattr(d, "min_validation_n_err_pt", None) is not None:
                stats["validation_err_pt"] = \
                    float(d.min_validation_n_err_pt)
            self.info("member %d/%d trained: %s", i + 1,
                      self.n_models, stats)
            self.workflows.append(wf)
            self.member_ids.append(i)
            local_err_pt.append(stats.get("validation_err_pt", np.nan))
        if pcount > 1 and allgather_sum(
                np.array([1.0 if local_exc else 0.0]))[0] > 0:
            raise RuntimeError(
                "ensemble member training failed on a process; every "
                "process aborts together") from local_exc
        self.member_stats = self._gather_member_stats(
            local_err_pt, pidx, pcount)
        return self

    def _gather_member_stats(self, local_err_pt: list[float],
                             pidx: int, pcount: int) -> list[dict]:
        """Per-member stats for ALL members, identical on every
        process.  Member *i* lives on process ``i % pcount`` at local
        slot ``i // pcount`` — the round-robin inverse."""
        if pcount == 1:
            return [{"seed": self.base_seed + i,
                     "validation_err_pt": err_pt}
                    if not np.isnan(err_pt)
                    else {"seed": self.base_seed + i}
                    for i, err_pt in enumerate(local_err_pt)]
        merged = merge_round_robin(local_err_pt, pidx, pcount,
                                   self.n_models)
        stats = []
        for i in range(self.n_models):
            entry = {"seed": self.base_seed + i}
            if not np.isnan(merged[i]):
                entry["validation_err_pt"] = float(merged[i])
            stats.append(entry)
        return stats

    # ------------------------------------------------------------------
    _SPLIT_DISAGREES = (
        "members disagree on sample labels: the loader's class split "
        "depends on the PRNG seed; give the loader a fixed split (or "
        "its own prng_name) so every member sees the same sample at "
        "the same global index")

    def _evaluate_stacked(self, klass: int) -> dict:
        """Mesh backend aggregate pass: every ``klass`` minibatch runs
        ONCE through the population's eval-variant step and all N
        members' probabilities come back as one (N, batch, classes)
        read — the aggregate pass costs one schedule sweep, not one
        per member.  Non-train segments ride natural order identically
        across members, so labels agree by construction."""
        if self.trainer is None:
            raise RuntimeError("train() first")
        region = self.trainer.region
        wf = self.trainer.template
        loader = wf.loader
        sum_probs: dict[int, np.ndarray] = {}
        labels: dict[int, int] = {}
        member_err_counts = np.zeros(self.n_models, dtype=np.int64)
        for pos, (cls, lo, hi) in enumerate(loader._schedule):
            if cls != klass:
                continue
            region.run_schedule_entry(pos)
            # the step binds its outputs anew: read what it bound
            probs = np.array(region.gather_leaf(wf.forwards[-1].output),
                             dtype=np.float64)        # (N, B, C)
            idx = np.asarray(
                region.gather_leaf(loader.minibatch_indices)[0])
            labs = np.asarray(
                region.gather_leaf(loader.minibatch_labels)[0])
            count = hi - lo
            pm = probs[:, :count, :]
            pred = pm.argmax(axis=2)
            member_err_counts += (
                pred != labs[None, :count]).sum(axis=1)
            for row in range(count):
                gi = int(idx[row])
                labels[gi] = int(labs[row])
                sum_probs[gi] = pm[:, row, :].sum(axis=0)
        if not sum_probs:
            raise ValueError(f"loader has no class-{klass} samples")
        ens_errs = sum(
            1 for gi, probs in sum_probs.items()
            if int(np.argmax(probs)) != labels[gi])
        result = {
            "n_samples": len(sum_probs),
            "member_err_pt": [100.0 * int(c) / len(sum_probs)
                              for c in member_err_counts],
            "ensemble_err_pt": 100.0 * ens_errs / len(sum_probs),
        }
        self.info("stacked ensemble eval: %s", result)
        return result

    def evaluate(self, klass: int = VALID) -> dict:
        """Aggregate evaluation on ``klass`` minibatches.

        Returns per-member error percentages and the ensemble's
        (averaged class probabilities → argmax).  Multi-process: every
        process contributes its local members' probability sums and
        receives the identical merged result."""
        if klass == TRAIN:
            raise ValueError("evaluate on VALID or TEST, not TRAIN")
        if self.backend == "mesh":
            return self._evaluate_stacked(klass)
        pidx, pcount = process_info()
        trained = self.workflows if pcount == 1 else self.member_stats
        if not trained:
            raise RuntimeError("train() first")
        sum_probs: dict[int, np.ndarray] = {}
        labels: dict[int, int] = {}
        member_errs: list[float] = []
        # In multi-process mode a LOCAL failure must not raise before
        # the collectives — a lone raise would leave the peers blocked
        # in _evaluate_merge's broadcasts.  Record it; the merge
        # gathers the failure flags so every process raises together.
        local_error: str | None = None
        for wf in self.workflows:
            outputs, wf_labels = class_forward_pass(wf, klass)
            if not outputs:
                local_error = f"loader has no class-{klass} samples"
                break
            errs = 0
            for gi, probs in outputs.items():
                if int(np.argmax(probs)) != wf_labels[gi]:
                    errs += 1
                if gi in sum_probs:
                    sum_probs[gi] = sum_probs[gi] + probs
                else:
                    sum_probs[gi] = probs.astype(np.float64)
                # per-index labels must agree across members — a
                # seed-dependent dataset split (e.g. a loader carving
                # validation via the global PRNG) would silently
                # average probabilities of unrelated samples
                if labels.setdefault(gi, wf_labels[gi]) != wf_labels[gi]:
                    local_error = self._SPLIT_DISAGREES
                    break
            if local_error:
                break
            member_errs.append(100.0 * errs / len(outputs))
        if pcount > 1:
            return self._evaluate_merge(sum_probs, labels, member_errs,
                                        local_error, pidx, pcount)
        if local_error:
            raise ValueError(local_error)
        ens_errs = sum(
            1 for gi, probs in sum_probs.items()
            if int(np.argmax(probs)) != labels[gi])
        result = {
            "n_samples": len(sum_probs),
            "member_err_pt": member_errs,
            "ensemble_err_pt": 100.0 * ens_errs / len(sum_probs),
        }
        self.info("ensemble eval: %s", result)
        return result

    def _evaluate_merge(self, sum_probs: dict, labels: dict,
                        member_errs: list, local_error: "str | None",
                        pidx: int, pcount: int) -> dict:
        """Lockstep cross-process merge of the aggregate pass.

        Process 0 always trained member 0 (round-robin), so its index
        set defines the reference sample order; a process with no
        members (``n_models < process_count``) contributes zeros.
        Failures (a local one recorded by ``evaluate``, or a
        cross-process split disagreement) are gathered as FLAGS before
        raising, so every process raises together — a lone raise would
        deadlock the peers in the later collectives."""
        if allgather_sum(np.array([1.0 if local_error else 0.0]))[0] > 0:
            raise ValueError(local_error or
                             "a peer process failed the ensemble "
                             "aggregate pass")
        have = bool(sum_probs)
        idxs = np.array(sorted(sum_probs), np.int64) if have \
            else np.zeros(0, np.int64)
        meta = broadcast_from_zero(
            np.array([len(idxs),
                      len(next(iter(sum_probs.values()))) if have
                      else 0], np.int64))
        n_samples, n_classes = int(meta[0]), int(meta[1])
        ref_idx = broadcast_from_zero(
            idxs if pidx == 0 else np.zeros(n_samples, np.int64))
        ref_lab = broadcast_from_zero(
            np.array([labels[g] for g in idxs], np.int64)
            if pidx == 0 else np.zeros(n_samples, np.int64))
        mismatch = 0.0
        if have:
            local_lab = np.array([labels[g] for g in idxs], np.int64)
            if (not np.array_equal(idxs, ref_idx)
                    or not np.array_equal(local_lab, ref_lab)):
                mismatch = 1.0
        if allgather_sum(np.array([mismatch]))[0] > 0:
            raise ValueError(self._SPLIT_DISAGREES)
        partial = (np.stack([sum_probs[g] for g in ref_idx]) if have
                   else np.zeros((n_samples, n_classes)))
        total = allgather_sum(partial)
        merged_errs = merge_round_robin(member_errs, pidx, pcount,
                                        self.n_models)
        ens_errs = int((total.argmax(axis=1) != ref_lab).sum())
        result = {
            "n_samples": n_samples,
            "member_err_pt": [float(e) for e in merged_errs],
            "ensemble_err_pt": 100.0 * ens_errs / n_samples,
        }
        self.info("ensemble eval (merged over %d processes): %s",
                  pcount, result)
        return result
