"""CIFAR-10 conv workflow, the survey's configuration #2 (port of
``znicz_tpu/models/samples/cifar.py``).

The reference's geometry and hyper-parameters, unchanged:

.. code-block:: text

    conv 32 5×5 p2 + ReLU → MaxAbs pool 3×3 /2 → LRN     (32→16)
    conv 32 5×5 p2 + ReLU → avg pool 3×3 /2 → LRN        (16→8)
    conv 64 5×5 p2 + ReLU → avg pool 3×3 /2              (8→4)
    softmax 10

trained by momentum SGD (lr 0.02, moment 0.9, weight decay 5e-4) on
minibatches of 100, the first 10 % of the training images held out for
validation; the LRNs take n = 5, α = 5e-5, β = 0.75.  The real CIFAR-10
binary batches are read from ``root.common.dirs.datasets`` when present,
else the reference's synthetic stand-in
(:func:`~znicz_tpu_torch.datasets.load_cifar10`).  Each pool's last
window is cut at the edge (32, 16 and 8 are even).

Unlike the reference's sample, the port's takes snapshots by default
(``snapshotter_config``: prefix ``cifar`` in
``root.common.dirs.snapshots``; ``--root cifar.snapshotter_config=None``
turns them off), so the CLI can resume a run::

    python -m znicz_tpu_torch cifar --root cifar.max_epochs=5
    python -m znicz_tpu_torch cifar -s <snapshot> --root cifar.max_epochs=10
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("cifar", {
    "minibatch_size": 100,
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "max_epochs": 30,
    "validation_fraction": 0.1,
    "snapshotter_config": {"prefix": "cifar"},
})


def layers(cfg) -> list[dict]:
    """The layer list of ``cfg`` (``root.cifar`` keys)."""
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"],
              "weights_decay": cfg["weights_decay"]}
    return [
        {"type": "conv_str",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": gd_cfg},
        {"type": "maxabs_pooling", "->": {"kx": 3, "ky": 3,
                                          "sliding": (2, 2)}},
        {"type": "norm", "->": {"n": 5, "alpha": 5e-5, "beta": 0.75}},
        {"type": "conv_str",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": gd_cfg},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "norm", "->": {"n": 5, "alpha": 5e-5, "beta": 0.75}},
        {"type": "conv_str",
         "->": {"n_kernels": 64, "kx": 5, "ky": 5, "padding": 2},
         "<-": gd_cfg},
        {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                       "sliding": (2, 2)}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": gd_cfg},
    ]


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.cifar`` updated by
    ``overrides``."""
    cfg = dict(root.cifar.as_dict())
    cfg.update(overrides)
    train_x, train_y, test_x, test_y = datasets.load_cifar10()
    n_valid = int(len(train_x) * cfg["validation_fraction"])
    return StandardWorkflow(
        name="cifar",
        loader_factory=lambda w: ArrayLoader(
            w,
            train_data=train_x[n_valid:], train_labels=train_y[n_valid:],
            valid_data=train_x[:n_valid], valid_labels=train_y[:n_valid],
            test_data=test_x, test_labels=test_y,
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0),
        layers=layers(cfg),
        decision_config={"max_epochs": cfg["max_epochs"]},
        snapshotter_config=cfg.get("snapshotter_config"))


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``):
    the launcher passes ``load`` (construct or resume) and ``main``
    (initialize and train)."""
    load(build)
    main()
