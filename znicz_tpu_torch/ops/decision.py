"""Decision unit: end-of-minibatch bookkeeping and the stop rule (port of
``znicz_tpu/ops/decision.py``).

``DecisionGD`` is a unit that runs on the host after every step (after
every chunk under ``run_chunked``, whose chunks end where an epoch
does):

- at the end of an epoch it reads the evaluator's per-class counters
  (one device read per epoch), turns them into error percentages and a
  mean loss per class, and compares the validation error (the train
  error when there is no validation set) against the best so far,
  raising ``improved``;
- it raises ``complete`` when ``max_epochs`` epochs are done or the
  error has not improved for ``fail_iterations`` epochs.

Its ``SNAPSHOT_ATTRS`` (the best errors so far, the epochs without
improvement and the epoch counts) go into a snapshot and come back
from it (:meth:`DecisionGD.load_state`), so a resumed run keeps its
best validation error and its stop rule's count.  The reference's
telemetry spans and resilience hooks (anomaly guard, heartbeats) are
not ported with it.
"""

from __future__ import annotations

import copy

from znicz_tpu_torch.loader.base import CLASS_NAME, TRAIN, VALID
from znicz_tpu_torch.units import Unit


class DecisionGD(Unit):
    """Classification decision driven by ``EvaluatorSoftmax``."""

    SNAPSHOT_ATTRS = ("epoch_n_err", "epoch_n_err_pt",
                      "min_validation_n_err", "min_validation_n_err_pt",
                      "min_train_n_err", "_epochs_without_improvement")

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
        self.epoch_n_err = [0, 0, 0]
        self.epoch_loss = [None, None, None]  # mean CE per class
        self.epoch_n_err_pt = [100.0, 100.0, 100.0]
        self.min_validation_n_err = None
        self.min_validation_n_err_pt = 100.0
        self.min_train_n_err = None
        #: the last completed epoch's error counts
        self.last_epoch_n_err = [None, None, None]

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
        loader, ev = self.loader, self.evaluator
        self.epoch_n_err = [int(n) for n in ev.epoch_n_err.tolist()]
        losses = ev.epoch_loss.tolist()
        ev.epoch_n_err.zero_()
        ev.epoch_loss.zero_()
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
