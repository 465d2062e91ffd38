"""Evaluators: the backward chain's seed error and the quality counters
(port of ``znicz_tpu/ops/evaluator.py``).

Both are units.  They take the last forward's ``output`` and, from the
loader, the count of valid samples and the minibatch class
(``minibatch_valid``, ``minibatch_class``).  The valid count is a device
tensor (the last minibatch of a class is short) and the class is part
of the region's key, so a captured graph bakes in neither.  Their epoch
sums live on the device, so the decision reads them once an epoch, not
once a step, and go into a snapshot and come back from it.

``EvaluatorSoftmax`` also takes the argmax (``max_idx``) and the labels
(``labels``), and gives

- ``err_output = mask·(p − onehot(t)) / max(valid, 1)`` — the combined
  softmax + cross-entropy derivative with respect to the logits, zero on
  the padded tail of a short minibatch;
- ``n_err`` — mispredictions among the valid samples;
- ``epoch_n_err`` and ``epoch_loss`` — per-class (test, validation,
  train) error counts and summed cross-entropy ``−log p(true)``; a
  non-finite step loss is left out of the sum, as in the reference;
- with ``compute_confusion``, ``confusion_matrix``: (3, C, C) int32
  counts by (class, true label, prediction).

``EvaluatorMSE`` takes the ``target`` (the loader's normalized
``minibatch_data`` for an autoencoder) and gives

- ``err_output = mask·(y − t)·2 / max(valid, 1)``;
- ``metrics`` — the step's summed squared error;
- ``epoch_sse`` — per-class sums of it, a non-finite step left out.

Its math is f32 whatever the activations are stored in: the sum over a
minibatch would lose small terms in bf16, and the decision selects
models on it.  The reference's fault-injection and anomaly-guard hooks
are not ported with them.

On the numpy oracle each runs the reference's ``numpy_run``: numpy
arrays in, the error out as an array, the counters and sums written in
place through views of their tensors, which the decision reads and
zeroes as on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.ops.nn_units import as_numpy, stored_f32


class EvaluatorBase(AcceleratedUnit):
    """The links and the snapshot protocol the evaluators share."""

    #: the device tensors a snapshot carries (the reference's names)
    SNAPSHOT_TENSORS: tuple = ()
    WRITES = ("err_output",)

    def __init__(self, workflow=None, name: str = "evaluator") -> None:
        super().__init__(workflow, name=name)
        self.err_output: torch.Tensor | None = None

    def region_key(self) -> tuple:
        return (self.minibatch_class,)

    def _valid_mask(self, n_rows: int, device) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
        """``(rows < valid, valid)`` for a minibatch of ``n_rows``."""
        valid = torch.as_tensor(self.minibatch_valid, device=device)
        return torch.arange(n_rows, device=device) < valid, valid

    def state_dict(self, allow_collective: bool = False) -> dict:
        return {name: getattr(self, name).cpu().numpy().copy()
                for name in self.SNAPSHOT_TENSORS
                if getattr(self, name) is not None}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Adopt the epoch counters of a snapshot (the reference's keys);
        a key the state lacks keeps its value."""
        for name in self.SNAPSHOT_TENSORS:
            t = getattr(self, name)
            if name in state and t is not None:
                t.copy_(torch.as_tensor(np.asarray(state[name]).reshape(
                    t.shape)).to(t.dtype))


class EvaluatorSoftmax(EvaluatorBase):
    """Softmax cross-entropy evaluator."""

    SNAPSHOT_TENSORS = ("epoch_n_err", "epoch_loss", "confusion_matrix")

    def __init__(self, workflow=None, name: str = "evaluator",
                 compute_confusion: bool = False) -> None:
        super().__init__(workflow, name=name)
        self.compute_confusion = bool(compute_confusion)
        self.n_err: torch.Tensor | None = None
        self.epoch_n_err: torch.Tensor | None = None
        self.epoch_loss: torch.Tensor | None = None
        self.confusion_matrix: torch.Tensor | None = None

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        dev = self.torch_device
        self.n_err = torch.zeros((), dtype=torch.int32, device=dev)
        self.epoch_n_err = torch.zeros(3, dtype=torch.int32, device=dev)
        self.epoch_loss = torch.zeros(3, dtype=torch.float32, device=dev)
        if self.compute_confusion:
            source = self._linked_attrs["output"].source
            if not source.is_initialized:
                raise AttributeError(f"{self}: {source} not initialized "
                                     f"yet")
            c = int(np.prod(source.output_shape))
            self.confusion_matrix = torch.zeros((3, c, c), dtype=torch.int32,
                                                device=dev)

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
        if self.compute_confusion:
            # masked rows add 0; an atomic add, exact in int32
            c = p.shape[1]
            self.confusion_matrix[minibatch_class].view(-1).index_add_(
                0, labels.long() * c + max_idx.long(), mask.to(torch.int32))
        return err

    def numpy_run(self) -> None:
        p = as_numpy(self.output)
        t = as_numpy(self.labels)
        n = p.shape[0]
        valid = int(self.minibatch_valid)
        mask = np.arange(n) < valid
        onehot = np.zeros_like(p)
        onehot[np.arange(n), t] = 1.0
        self.err_output = stored_f32(
            mask[:, None] * (p - onehot) / max(valid, 1))
        pred = as_numpy(self.max_idx)
        n_err = int(np.sum((pred != t) & mask))
        as_numpy(self.n_err)[...] = n_err
        cls = int(self.minibatch_class)
        as_numpy(self.epoch_n_err)[cls] += n_err
        p_true = np.maximum(p[np.arange(n), t], 1e-30)
        loss_sum = np.float32(np.sum(mask * -np.log(p_true)))
        as_numpy(self.epoch_loss)[cls] += float(
            loss_sum if np.isfinite(loss_sum) else 0.0)
        if self.compute_confusion:
            np.add.at(as_numpy(self.confusion_matrix)[cls],
                      (t[mask], pred[mask]), 1)


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared-error evaluator (regression, autoencoders)."""

    SNAPSHOT_TENSORS = ("epoch_sse",)
    WRITES = ("err_output", "metrics")

    def __init__(self, workflow=None, name: str = "evaluator") -> None:
        super().__init__(workflow, name=name)
        self.metrics: torch.Tensor | None = None
        self.epoch_sse: torch.Tensor | None = None

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        dev = self.torch_device
        self.metrics = torch.zeros((), dtype=torch.float32, device=dev)
        self.epoch_sse = torch.zeros(3, dtype=torch.float32, device=dev)

    def device_run(self) -> None:
        self.err_output = self.evaluate(self.output, self.target,
                                        self.minibatch_class)

    @torch.no_grad()
    def evaluate(self, output: torch.Tensor, target: torch.Tensor,
                 minibatch_class: int) -> torch.Tensor:
        """One minibatch: returns ``err_output`` (f32, the output's
        shape) and writes the step's summed squared error into
        ``metrics``."""
        y = output.float()
        batch = y.shape[0]
        t = target.reshape(batch, -1).float()
        mask, valid = self._valid_mask(batch, y.device)
        diff = mask[:, None] * (y.reshape(batch, -1) - t)
        err = (diff * (2.0 / valid.clamp(min=1).float())).reshape(y.shape)
        sse = (diff * diff).sum()
        self.metrics.copy_(sse)
        self.epoch_sse[minibatch_class] += torch.where(
            torch.isfinite(sse), sse, torch.zeros_like(sse))
        return err

    def numpy_run(self) -> None:
        y = as_numpy(self.output)
        batch = y.shape[0]
        t = as_numpy(self.target).reshape(batch, -1).astype(np.float32)
        valid = int(self.minibatch_valid)
        mask = np.arange(batch) < valid
        diff = mask[:, None] * (y.reshape(batch, -1) - t)
        self.err_output = stored_f32(
            (diff * (2.0 / max(valid, 1))).reshape(y.shape))
        sse = np.float32(np.sum(diff * diff))
        as_numpy(self.metrics)[...] = sse
        as_numpy(self.epoch_sse)[int(self.minibatch_class)] += \
            sse if np.isfinite(sse) else 0.0
