"""Mnist784, the 784 → 64 → 784 fully-connected autoencoder (port of
``znicz_tpu/models/samples/mnist784.py``).

784 → 64 (tanh) → 784 (linear), trained by momentum SGD (lr 0.003,
moment 0.9) on minibatches of 100 to reconstruct its input: the loss is
the MSE against the loader's normalized minibatch (pixels scaled to
[0, 1]), which the images carry no labels for.  The data is
:func:`~znicz_tpu_torch.datasets.load_mnist`'s; ``n_train_samples``
caps the training images (and the test images at a sixth of it).  A
``snapshotter_config``, ``lr_adjuster_config`` or ``evaluator_config``
leaf is passed to the workflow::

    python -m znicz_tpu_torch mnist784 -b cpu --root mnist784.max_epochs=2
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("mnist784", {
    "minibatch_size": 100,
    "learning_rate": 0.003,
    "gradient_moment": 0.9,
    "bottleneck": 64,
    "max_epochs": 20,
    "validation_fraction": 0.1,
})


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.mnist784`` updated by
    ``overrides``."""
    cfg = dict(root.mnist784.as_dict())
    cfg.update(overrides)
    wf_kwargs = {k: cfg.pop(k) for k in ("snapshotter_config",
                                         "lr_adjuster_config",
                                         "evaluator_config")
                 if k in cfg}
    train_x, _, test_x, _ = datasets.load_mnist()
    limit = cfg.get("n_train_samples")
    if limit:
        train_x, test_x = train_x[:int(limit)], test_x[:max(
            1, int(limit) // 6)]
    n_valid = int(len(train_x) * cfg["validation_fraction"])
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"]}
    wf = StandardWorkflow(
        name="mnist784",
        loader_factory=lambda w: ArrayLoader(
            w,
            train_data=train_x[n_valid:].reshape(-1, 784),
            valid_data=train_x[:n_valid].reshape(-1, 784),
            test_data=test_x.reshape(-1, 784),
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=1.0 / 255.0),
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": cfg["bottleneck"]},
             "<-": gd_cfg},
            {"type": "all2all", "->": {"output_sample_shape": 784},
             "<-": gd_cfg},
        ],
        loss="mse",
        decision_config={"max_epochs": cfg["max_epochs"]},
        **wf_kwargs)
    wf._max_fires = 100_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
