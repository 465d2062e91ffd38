"""Softmax evaluator: the backward chain's seed error and the quality
counters (port of ``znicz_tpu/ops/evaluator.py``).

``EvaluatorSoftmax`` is a unit.  It takes the softmax output ``p``
(f32) and the argmax from the last forward (``output``, ``max_idx``),
and the labels, the count of valid samples and the minibatch class
from the loader (``labels``, ``minibatch_valid``, ``minibatch_class``),
and gives

- ``err_output = mask·(p − onehot(t)) / max(valid, 1)`` — the combined
  softmax + cross-entropy derivative with respect to the logits, zero on
  the padded tail of a short minibatch;
- ``n_err`` — mispredictions among the valid samples;
- ``epoch_n_err`` and ``epoch_loss`` — per-class (test, validation,
  train) error counts and summed cross-entropy ``−log p(true)`` for the
  epoch, accumulated on the device so the decision unit reads them
  once per epoch, not once per step.  A non-finite step loss is left
  out of the accumulator, as in the reference.

The valid count is a device tensor (the last minibatch of a class is
short) and the class is part of the region's key, so a captured graph
bakes in neither.  The two epoch accumulators go into a snapshot and
come back from it.  The confusion matrix and ``EvaluatorMSE`` arrive
with later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit


class EvaluatorSoftmax(AcceleratedUnit):
    """Softmax cross-entropy evaluator."""

    def __init__(self, workflow=None, name: str = "evaluator") -> None:
        super().__init__(workflow, name=name)
        self.n_err: torch.Tensor | None = None
        self.epoch_n_err: torch.Tensor | None = None
        self.epoch_loss: torch.Tensor | None = None
        self.err_output: torch.Tensor | None = None

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        dev = self.torch_device
        self.n_err = torch.zeros((), dtype=torch.int32, device=dev)
        self.epoch_n_err = torch.zeros(3, dtype=torch.int32, device=dev)
        self.epoch_loss = torch.zeros(3, dtype=torch.float32, device=dev)

    def region_key(self) -> tuple:
        return (self.minibatch_class,)

    def device_run(self) -> None:
        self.err_output = self.evaluate(
            self.output, self.max_idx, self.labels, self.minibatch_valid,
            self.minibatch_class)

    @torch.no_grad()
    def evaluate(self, p: torch.Tensor, max_idx: torch.Tensor,
                 labels: torch.Tensor, valid: torch.Tensor,
                 minibatch_class: int) -> torch.Tensor:
        """One minibatch: returns ``err_output`` (f32, p's shape);
        ``valid`` is the count of valid samples, a 0-d device tensor."""
        n = p.shape[0]
        valid = torch.as_tensor(valid, device=p.device)
        mask = torch.arange(n, device=p.device) < valid
        onehot = (labels[:, None] == torch.arange(
            p.shape[1], device=p.device)[None, :]).to(p.dtype)
        err = mask[:, None] * (p - onehot) / valid.clamp(min=1).to(p.dtype)
        self.n_err = ((max_idx != labels) & mask).sum().to(torch.int32)
        self.epoch_n_err[minibatch_class] += self.n_err
        p_true = torch.clamp(p[torch.arange(n, device=p.device),
                               labels.long()], min=1e-30)
        loss = (mask * -torch.log(p_true)).sum()
        self.epoch_loss[minibatch_class] += torch.where(
            torch.isfinite(loss), loss, torch.zeros_like(loss))
        return err

    #: the counters a snapshot carries (the reference's names)
    SNAPSHOT_TENSORS = ("epoch_n_err", "epoch_loss")

    def state_dict(self, allow_collective: bool = False) -> dict:
        return {name: getattr(self, name).cpu().numpy().copy()
                for name in self.SNAPSHOT_TENSORS}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Adopt the epoch counters of a snapshot (the reference's keys);
        a key the state lacks keeps its value."""
        for name in self.SNAPSHOT_TENSORS:
            if name in state:
                t = getattr(self, name)
                t.copy_(torch.as_tensor(np.asarray(state[name]).reshape(
                    t.shape)).to(t.dtype))
