"""Decision units: end-of-minibatch bookkeeping and the stop rule (port
of ``znicz_tpu/ops/decision.py``).

A decision is a unit that runs on the host after every step (after
every chunk under ``run_chunked``, whose chunks end where an epoch
does).  :class:`DecisionBase` holds what both kinds share:

- at the end of an epoch the subclass's ``on_epoch_ended`` reads the
  evaluator's per-class sums (one device read per epoch), compares the
  validation metric (the train metric when there is no validation set)
  against the best so far and raises ``improved``;
- it raises ``complete`` when ``max_epochs`` epochs are done or the
  metric has not improved for ``fail_iterations`` epochs.

:class:`DecisionGD` decides on ``EvaluatorSoftmax``'s error counts (and
keeps the last epoch's confusion matrices when the evaluator counts
them), :class:`DecisionMSE` on ``EvaluatorMSE``'s mean squared error.
Each one's ``SNAPSHOT_ATTRS`` (the best metric so far, the epochs
without improvement, the epoch's sums) go into a snapshot and come back
from it, so a resumed run keeps its best and its stop rule's count.
The reference's telemetry spans and resilience hooks (anomaly guard,
heartbeats) are not ported with them.
"""

from __future__ import annotations

import copy

import numpy as np

from znicz_tpu_torch.loader.base import CLASS_NAME, TRAIN, VALID
from znicz_tpu_torch.units import Unit


class DecisionBase(Unit):
    """The epoch bookkeeping and the stop rule of a decision."""

    SNAPSHOT_ATTRS: tuple = ()

    def __init__(self, workflow=None, name: str = "decision",
                 max_epochs: int | None = None,
                 fail_iterations: int = 100) -> None:
        super().__init__(workflow, name=name)
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = False
        self.improved = False
        self.epoch_ended = False
        # linked by the workflow
        self.loader = None
        self.evaluator = None
        self._epochs_without_improvement = 0

    def run(self) -> None:
        self.decide()
        wf = self.workflow
        if wf is not None:
            wf.on_step_boundary()

    def decide(self) -> None:
        loader = self.loader
        self.improved = False
        self.epoch_ended = False
        if not loader.epoch_ended:
            return
        self.on_epoch_ended()
        self.epoch_ended = True
        if self.improved:
            self._epochs_without_improvement = 0
        else:
            self._epochs_without_improvement += 1
        if self.max_epochs is not None \
                and loader.epoch_number + 1 >= self.max_epochs:
            self.complete = True
        if self._epochs_without_improvement >= self.fail_iterations:
            self.info("no improvement for %d epochs — stopping",
                      self._epochs_without_improvement)
            self.complete = True

    def on_epoch_ended(self) -> None:
        """Read the epoch's sums and set ``improved``."""
        raise NotImplementedError

    def state_dict(self, allow_collective: bool = False) -> dict:
        return {name: copy.deepcopy(getattr(self, name))
                for name in self.SNAPSHOT_ATTRS}

    def load_state(self, state: dict) -> None:
        """Adopt the counters of a snapshot (the reference's keys); a key
        the state lacks keeps its initial value, as the reference's
        ``Unit.load_state`` leaves it."""
        for name in self.SNAPSHOT_ATTRS:
            if name in state:
                setattr(self, name, copy.deepcopy(state[name]))


class DecisionGD(DecisionBase):
    """Classification decision driven by ``EvaluatorSoftmax``."""

    SNAPSHOT_ATTRS = ("epoch_n_err", "epoch_n_err_pt",
                      "min_validation_n_err", "min_validation_n_err_pt",
                      "min_train_n_err", "_epochs_without_improvement")

    def __init__(self, workflow=None, name: str = "decision",
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.epoch_n_err = [0, 0, 0]
        self.epoch_loss = [None, None, None]  # mean CE per class
        self.epoch_n_err_pt = [100.0, 100.0, 100.0]
        self.min_validation_n_err = None
        self.min_validation_n_err_pt = 100.0
        self.min_train_n_err = None
        #: the last completed epoch's error counts
        self.last_epoch_n_err = [None, None, None]
        #: the last completed epoch's (C, C) confusion counts per class
        #: (true label × prediction), when the evaluator counts them
        self.confusion_matrixes = [None, None, None]

    def on_epoch_ended(self) -> None:
        loader, ev = self.loader, self.evaluator
        self.epoch_n_err = [int(n) for n in ev.epoch_n_err.tolist()]
        losses = ev.epoch_loss.tolist()
        ev.epoch_n_err.zero_()
        ev.epoch_loss.zero_()
        cm = getattr(ev, "confusion_matrix", None)
        if cm is not None:
            counts = cm.cpu().numpy()
            self.confusion_matrixes = [np.array(counts[c]) for c in range(3)]
            cm.zero_()
        # summed −log p(true) → mean per sample (the loss curve)
        self.epoch_loss = [losses[c] / loader.class_lengths[c]
                           if loader.class_lengths[c] else None
                           for c in range(3)]
        for cls in range(3):
            length = loader.class_lengths[cls]
            if length:
                self.epoch_n_err_pt[cls] = \
                    100.0 * self.epoch_n_err[cls] / length
        has_valid = loader.class_lengths[VALID] > 0
        n_err = self.epoch_n_err[VALID if has_valid else TRAIN]
        best = (self.min_validation_n_err if has_valid
                else self.min_train_n_err)
        if best is None or n_err < best:
            if has_valid:
                self.min_validation_n_err = n_err
                self.min_validation_n_err_pt = self.epoch_n_err_pt[VALID]
            else:
                self.min_train_n_err = n_err
            self.improved = True
        self.info(
            "epoch %d: %s", loader.epoch_number,
            "  ".join(f"{CLASS_NAME[c]} err {self.epoch_n_err[c]} "
                      f"({self.epoch_n_err_pt[c]:.2f}%)"
                      for c in range(3) if loader.class_lengths[c]))
        self.last_epoch_n_err = list(self.epoch_n_err)
        self.epoch_n_err = [0, 0, 0]


class DecisionMSE(DecisionBase):
    """Regression and autoencoder decision driven by ``EvaluatorMSE``:
    the epoch's mean squared error per sample, by class."""

    SNAPSHOT_ATTRS = ("epoch_sse", "epoch_mse", "epoch_mse_history",
                      "min_validation_mse", "min_train_mse",
                      "_epochs_without_improvement")

    def __init__(self, workflow=None, name: str = "decision",
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.epoch_sse = [0.0, 0.0, 0.0]
        self.epoch_mse = [np.inf, np.inf, np.inf]
        #: per-class MSE, one entry per finished epoch
        self.epoch_mse_history: list[list[float]] = [[], [], []]
        self.min_validation_mse = None
        self.min_train_mse = None

    def on_epoch_ended(self) -> None:
        loader, ev = self.loader, self.evaluator
        self.epoch_sse = [float(x) for x in ev.epoch_sse.tolist()]
        ev.epoch_sse.zero_()
        for cls in range(3):
            length = loader.class_lengths[cls]
            if length:
                self.epoch_mse[cls] = self.epoch_sse[cls] / length
                self.epoch_mse_history[cls].append(self.epoch_mse[cls])
        has_valid = loader.class_lengths[VALID] > 0
        mse = self.epoch_mse[VALID if has_valid else TRAIN]
        best = self.min_validation_mse if has_valid else self.min_train_mse
        if best is None or mse < best:
            if has_valid:
                self.min_validation_mse = mse
            else:
                self.min_train_mse = mse
            self.improved = True
        self.info(
            "epoch %d: %s", loader.epoch_number,
            "  ".join(f"{CLASS_NAME[c]} mse {self.epoch_mse[c]:.6f}"
                      for c in range(3) if loader.class_lengths[c]))
        self.epoch_sse = [0.0, 0.0, 0.0]
