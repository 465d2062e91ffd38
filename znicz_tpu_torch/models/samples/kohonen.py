"""The Kohonen SOM sample (port of ``znicz_tpu/models/samples/kohonen.py``):
an unsupervised 2-D map of a point cloud, a ring and two blobs made
from a seed (the reference's ``make_data``), 90 % for training.

.. code-block:: text

    repeater → loader → kohonen (winners, hits, QE) → trainer
             → decision (epochs) → loop

The quality metric is the mean quantization error (the squared
distance to the winner), summed on the device over an epoch and read
by the decision once an epoch, which also counts the neurons used and
zeroes both sums in place.  The loader's gather, the forward and the
trainer are one region (``som_region``): on the card a CUDA graph a key
(train, validation), on the CPU the same units eagerly; on the numpy
oracle the units run one by one::

    python -m znicz_tpu_torch kohonen -b cpu
    python -m znicz_tpu_torch kohonen -b numpy --root kohonen.max_epochs=3
    python -m znicz_tpu_torch kohonen                # on the card
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.loop_workflow import LoopWorkflow
from znicz_tpu_torch.ops.decision import DecisionBase
from znicz_tpu_torch.ops.kohonen import KohonenForward, KohonenTrainer
from znicz_tpu_torch.ops.nn_units import as_numpy
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("kohonen", {
    "minibatch_size": 40,
    "shape": (8, 8),
    "learning_rate": 0.5,
    "max_epochs": 12,
})


def make_data(seed: int = 31, n: int = 800):
    """A ring and two blobs in 2-D, the classic SOM demo (the
    reference's, copied: the same bytes from the same seed)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n // 2)
    ring = np.stack([np.cos(theta), np.sin(theta)], 1)
    ring += 0.05 * rng.normal(size=ring.shape)
    blobs = np.concatenate([
        [2.0, 0.5] + 0.15 * rng.normal(size=(n // 4, 2)),
        [-1.5, -1.5] + 0.15 * rng.normal(size=(n // 4, 2))])
    data = np.concatenate([ring, blobs]).astype(np.float32)
    return data[rng.permutation(len(data))]


class DecisionSOM(DecisionBase):
    """Epoch bookkeeping on the accumulated quantization error."""

    SNAPSHOT_ATTRS = ("epoch_qe", "best_qe", "_epochs_without_improvement")

    def __init__(self, workflow=None, name: str = "decision",
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.forward = None   # KohonenQE: hits and epoch_qe live there
        self.epoch_qe = np.inf
        self.best_qe = None
        #: neurons that won a sample in the last epoch
        self.neurons_used = 0

    def on_epoch_ended(self) -> None:
        fwd = self.forward
        acc, hits = fwd.epoch_qe, fwd.hits
        n = max(self.loader.total_samples, 1)
        # one read of each a epoch; both zeroed in place (the tensors a
        # captured step adds into)
        self.epoch_qe = float(acc) / n
        acc.zero_()
        self.neurons_used = int((hits > 0).sum())
        hits.zero_()
        if self.best_qe is None or self.epoch_qe < self.best_qe:
            self.best_qe = self.epoch_qe
            self.improved = True
        self.info("epoch %d: quantization err %.5f, neurons used %d/%d",
                  self.loader.epoch_number, self.epoch_qe,
                  self.neurons_used, fwd.n_neurons)


class KohonenQE(KohonenForward):
    """``KohonenForward`` and the epoch's sum of the quantization error
    on the device (read once an epoch, as the evaluators' sums are)."""

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.register_buffer("epoch_qe", None)

    def init_params(self, device) -> None:
        if self.epoch_qe is None:
            self.epoch_qe = torch.zeros((), dtype=torch.float32)
        super().init_params(device)

    @torch.no_grad()
    def device_run(self) -> None:
        super().device_run()
        self.epoch_qe.add_(self.output.sum())

    def numpy_run(self) -> None:
        super().numpy_run()
        as_numpy(self.epoch_qe)[...] += self.output.sum()


class KohonenWorkflow(LoopWorkflow):
    """The SOM's training loop."""

    REGION_NAME = "som_region"

    def __init__(self, workflow=None, name: str | None = None,
                 loader_factory=None, shape=(8, 8),
                 learning_rate: float = 0.5, max_epochs: int = 12,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.loader = loader_factory(self)
        self.forward = KohonenQE(shape=shape, workflow=self, name="kohonen")
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"))
        self.trainer = KohonenTrainer(self, name="trainer",
                                      learning_rate=learning_rate)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))
        self.trainer.link_attrs(self.loader, "forward_mode", two_way=False)
        self.trainer.link_attrs(self.forward, "weights", "winners")
        self.trainer.shape_grid = tuple(shape)
        self.decision = DecisionSOM(self, name="decision",
                                    max_epochs=max_epochs)
        self.decision.loader = self.loader
        self.decision.forward = self.forward
        self.link_loop()

    def hot_chain_units(self) -> list:
        return [self.loader, self.forward, self.trainer]


def build(**overrides) -> KohonenWorkflow:
    """The sample's workflow from ``root.kohonen`` updated by
    ``overrides``."""
    cfg = dict(root.kohonen.as_dict())
    cfg.update(overrides)
    data = make_data()
    n_train = int(0.9 * len(data))
    wf = KohonenWorkflow(
        name="kohonen",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:n_train], valid_data=data[n_train:],
            minibatch_size=cfg["minibatch_size"]),
        shape=tuple(cfg["shape"]),
        learning_rate=cfg["learning_rate"],
        max_epochs=cfg["max_epochs"])
    wf._max_fires = 10_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
