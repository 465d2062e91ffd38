"""MnistAE, the convolutional autoencoder (port of
``znicz_tpu/models/samples/mnist_ae.py``).

.. code-block:: text

    conv 9 5×5 /2 (tanh) → maxpool 2×2         (28→12→6)
    depooling (tied to the pool) → deconv (tanh, tied to the conv)
                                                (6→12→28)

trained by momentum SGD (lr 0.0005, moment 0.9) on minibatches of 100
to reconstruct its input (the MSE against the loader's minibatch,
pixels scaled to [0, 1]), 10 % of the training images held out for
validation.  The deconv takes the conv's geometry and gives back its
28×28×1 input; its own weights unless the layer says
``tied_weights``.  The data is
:func:`~znicz_tpu_torch.datasets.load_mnist`'s; ``n_train_samples``
caps the training images (and the test images at a sixth of it).  A
``snapshotter_config``, ``lr_adjuster_config`` or ``evaluator_config``
leaf is passed to the workflow::

    python -m znicz_tpu_torch mnist_ae -b cpu --root mnist_ae.max_epochs=1
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("mnist_ae", {
    "minibatch_size": 100,
    "learning_rate": 0.0005,
    "gradient_moment": 0.9,
    "n_kernels": 9,
    "kx": 5,
    "ky": 5,
    "sliding": (2, 2),
    "max_epochs": 15,
    "validation_fraction": 0.1,
})

WORKFLOW_KEYS = ("snapshotter_config", "lr_adjuster_config",
                 "evaluator_config")


def ae_layers(cfg: dict) -> list[dict]:
    """conv → max pooling → depooling → deconv, the decoder tied to the
    encoder (the reference's layer list for ``cfg``)."""
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"]}
    conv_cfg = {"n_kernels": cfg["n_kernels"], "kx": cfg["kx"],
                "ky": cfg["ky"], "sliding": tuple(cfg["sliding"])}
    return [
        {"type": "conv_tanh", "->": conv_cfg, "<-": gd_cfg},   # 0
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},     # 1
        {"type": "depooling", "tied_to": 1},                   # 2
        {"type": "deconv_tanh", "tied_to": 0, "<-": gd_cfg},   # 3
    ]


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.mnist_ae`` updated by
    ``overrides``."""
    cfg = {**root.mnist_ae.as_dict(), **overrides}
    wf_kwargs = {k: cfg.pop(k) for k in WORKFLOW_KEYS if k in cfg}
    train_x, _, test_x, _ = datasets.load_mnist()
    limit = cfg.get("n_train_samples")
    if limit:
        train_x, test_x = train_x[:int(limit)], test_x[:max(
            1, int(limit) // 6)]
    n_valid = int(len(train_x) * cfg["validation_fraction"])
    wf = StandardWorkflow(
        name="mnist_ae",
        loader_factory=lambda w: ArrayLoader(
            w,
            train_data=train_x[n_valid:, :, :, None],
            valid_data=train_x[:n_valid, :, :, None],
            test_data=test_x[:, :, :, None],
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=1.0 / 255.0),
        layers=ae_layers(cfg),
        loss="mse",
        decision_config={"max_epochs": cfg["max_epochs"]},
        **wf_kwargs)
    wf._max_fires = 100_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
