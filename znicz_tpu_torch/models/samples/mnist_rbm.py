"""MnistRBM, the RBM pretraining sample (port of
``znicz_tpu/models/samples/mnist_rbm.py``).

The dataset is the reference's synthetic stand-in, made from a seed:
noisy binary prototype patterns (8 × 8, six classes, 64 a class) in
[0, 1], 80 % for training and the rest for validation.  The workflow
is the reference's own loop (an RBM has no backward chain, so
``StandardWorkflow`` does not apply):

.. code-block:: text

    repeater → loader → encoder (All2AllSigmoid) → binarization
             → gradient_rbm (CD-1, the encoder's weights and bias shared)
             → evaluator (reconstruction MSE) → decision → loop

The loader's gather, the encoder, the sampling, the CD update and the
evaluation are one region (``rbm_region``): on the card a CUDA graph a
key (train, validation), on the CPU the same units eagerly; on the
numpy oracle the units run one by one::

    python -m znicz_tpu_torch mnist_rbm -b cpu
    python -m znicz_tpu_torch mnist_rbm -b numpy --root mnist_rbm.max_epochs=3
    python -m znicz_tpu_torch mnist_rbm              # on the card
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.loop_workflow import LoopWorkflow
from znicz_tpu_torch.ops.all2all import All2AllSigmoid
from znicz_tpu_torch.ops.decision import DecisionMSE
from znicz_tpu_torch.ops.rbm_units import (Binarization, EvaluatorRBM,
                                           GradientRBM)
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("mnist_rbm", {
    "minibatch_size": 32,
    "n_hidden": 48,
    "learning_rate": 0.08,
    "max_epochs": 25,
})


def make_data(seed: int = 23, n_per_class: int = 64, n_classes: int = 6,
              side: int = 8):
    """Noisy binary prototype images in [0, 1] (the reference's, copied:
    the same bytes from the same seed)."""
    rng = np.random.default_rng(seed)
    protos = (rng.uniform(size=(n_classes, side * side)) < 0.35)
    data = np.concatenate([
        np.clip(p.astype(np.float32)
                + 0.15 * rng.normal(size=(n_per_class, side * side)),
                0.0, 1.0)
        for p in protos]).astype(np.float32)
    order = rng.permutation(len(data))
    return data[order]


class RBMWorkflow(LoopWorkflow):
    """CD-1 RBM training workflow."""

    REGION_NAME = "rbm_region"

    def __init__(self, workflow=None, name: str | None = None,
                 loader_factory=None, n_hidden: int = 48,
                 learning_rate: float = 0.08,
                 max_epochs: int | None = 25, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.loader = loader_factory(self)
        self.encoder = All2AllSigmoid(output_sample_shape=n_hidden,
                                      workflow=self, name="encoder")
        self.encoder.link_attrs(self.loader, ("input", "minibatch_data"))
        self.binarization = Binarization(workflow=self,
                                         name="binarization")
        self.binarization.link_attrs(self.encoder, ("input", "output"))
        self.grbm = GradientRBM(self, name="gradient_rbm",
                                learning_rate=learning_rate)
        self.grbm.link_attrs(self.loader, ("input", "minibatch_data"))
        self.grbm.link_attrs(self.loader, "forward_mode", two_way=False)
        self.grbm.link_attrs(self.encoder, ("hidden", "output"),
                             "weights", ("hbias", "bias"))
        self.grbm.link_attrs(self.binarization,
                             ("hidden_sample", "output"))
        self.evaluator = EvaluatorRBM(self, name="evaluator")
        self.evaluator.link_attrs(self.grbm, ("output", "reconstruction"))
        self.evaluator.link_attrs(self.loader, ("target", "minibatch_data"),
                                  "minibatch_valid", "minibatch_class")
        self.decision = DecisionMSE(self, name="decision",
                                    max_epochs=max_epochs)
        self.decision.loader = self.loader
        self.decision.evaluator = self.evaluator
        self.link_loop()

    def hot_chain_units(self) -> list:
        return [self.loader, self.encoder, self.binarization, self.grbm,
                self.evaluator]


def build(**overrides) -> RBMWorkflow:
    """The sample's workflow from ``root.mnist_rbm`` updated by
    ``overrides``."""
    cfg = dict(root.mnist_rbm.as_dict())
    cfg.update(overrides)
    data = make_data()
    n_train = int(0.8 * len(data))
    wf = RBMWorkflow(
        name="mnist_rbm",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:n_train], valid_data=data[n_train:],
            minibatch_size=cfg["minibatch_size"]),
        n_hidden=cfg["n_hidden"],
        learning_rate=cfg["learning_rate"],
        max_epochs=cfg["max_epochs"])
    wf._max_fires = 10_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
