"""MnistSimple, the 784-100-10 MLP of the survey's configuration #1
(port of ``znicz_tpu/models/samples/mnist.py``).

784 → 100 (tanh) → 10 (softmax), trained by momentum SGD (lr 0.03,
moment 0.9, weight decay 5e-4) on minibatches of 100, the pixels scaled
to [−1, 1], the first 10 % of the training images held out for
validation.  The idx files under ``root.common.dirs.datasets/mnist`` are
read when all four are there, else the reference's synthetic stand-in of
6000 + 1000 digits (:func:`~znicz_tpu_torch.datasets.load_mnist`)::

    python -m znicz_tpu_torch mnist -b cpu --root mnist.max_epochs=2
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("mnist", {
    "minibatch_size": 100,
    "learning_rate": 0.03,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "hidden": 100,
    "max_epochs": 30,
    "validation_fraction": 0.1,
})


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.mnist`` updated by
    ``overrides``."""
    cfg = dict(root.mnist.as_dict())
    cfg.update(overrides)
    train_x, train_y, test_x, test_y = datasets.load_mnist()
    n_valid = int(len(train_x) * cfg["validation_fraction"])
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"],
              "weights_decay": cfg["weights_decay"]}
    wf = StandardWorkflow(
        name="mnist",
        loader_factory=lambda w: ArrayLoader(
            w,
            train_data=train_x[n_valid:].reshape(-1, 784),
            train_labels=train_y[n_valid:],
            valid_data=train_x[:n_valid].reshape(-1, 784),
            valid_labels=train_y[:n_valid],
            test_data=test_x.reshape(-1, 784), test_labels=test_y,
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0),
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": cfg["hidden"]},
             "<-": gd_cfg},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": gd_cfg},
        ],
        decision_config={"max_epochs": cfg["max_epochs"]})
    wf._max_fires = 100_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
