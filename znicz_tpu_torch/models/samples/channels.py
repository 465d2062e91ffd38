"""Channels, the TV-channel logo classifier (port of
``znicz_tpu/models/samples/channels.py``).

Color 32×32 logo crops through a conv net:

.. code-block:: text

    conv 16 5×5 p2 + ReLU → maxpool 2×2 /2      (32→16)
    conv 32 5×5 p2 + ReLU → maxpool 2×2 /2      (16→8)
    fc 64 (tanh) → softmax 8

trained by momentum SGD (lr 0.02, moment 0.9, weight decay 5e-4) on
minibatches of 50, 15 % of the images held out for validation.  With no
``root.common.dirs.datasets/channels`` directory the data is the
reference's stand-in: 60 images a channel of
:func:`~znicz_tpu_torch.datasets.synthetic_images` (seed 48), uint8,
scaled to [−1, 1] by the loader.  A real directory (one subdirectory per
channel, read by the reference's ``FullBatchImageLoader``) waits for
the image loader (A10) and raises::

    python -m znicz_tpu_torch channels -b cpu --root channels.max_epochs=2
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.samples._vision import refuse_data_dir
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("channels", {
    "minibatch_size": 50,
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "n_channels": 8,
    "image_size": 32,
    "max_epochs": 30,
    "validation_fraction": 0.15,
})


def layers(cfg) -> list[dict]:
    """The layer list of ``cfg`` (``root.channels`` keys)."""
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"],
              "weights_decay": cfg["weights_decay"]}
    return [
        {"type": "conv_str",
         "->": {"n_kernels": 16, "kx": 5, "ky": 5, "padding": 2},
         "<-": gd_cfg},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2,
                                       "sliding": (2, 2)}},
        {"type": "conv_str",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": gd_cfg},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2,
                                       "sliding": (2, 2)}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 64},
         "<-": gd_cfg},
        {"type": "softmax",
         "->": {"output_sample_shape": cfg["n_channels"]},
         "<-": gd_cfg},
    ]


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.channels`` updated by
    ``overrides``."""
    cfg = {**root.channels.as_dict(), **overrides}
    refuse_data_dir("channels", "channels")
    x, y, _, _ = datasets.synthetic_images(
        n_train=cfg["n_channels"] * 60, n_test=0, size=cfg["image_size"],
        channels=3, n_classes=cfg["n_channels"], seed=48)
    n_valid = int(len(x) * cfg["validation_fraction"])
    wf = StandardWorkflow(
        name="channels",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x[n_valid:], train_labels=y[n_valid:],
            valid_data=x[:n_valid], valid_labels=y[:n_valid],
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0),
        layers=layers(cfg),
        decision_config={"max_epochs": cfg["max_epochs"]})
    wf._max_fires = 100_000_000
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
