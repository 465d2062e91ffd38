"""Hands, the open/closed hand-posture classifier (port of
``znicz_tpu/models/samples/hands.py``).

Grayscale 24×24 images, flattened, through 576 → 30 (tanh) → 2
(softmax), trained by momentum SGD (lr 0.05, moment 0.9) on minibatches
of 40, 15 % of the images held out for validation.  With no
``root.common.dirs.datasets/hands`` directory the data is the
reference's stand-in: 400 two-class
:func:`~znicz_tpu_torch.datasets.synthetic_images` (seed 47) scaled to
[−1, 1].  A real directory (one subdirectory per posture) is decoded
once by ``FullBatchImageLoader``, grayscale, as in the reference::

    python -m znicz_tpu_torch hands -b cpu
"""

from __future__ import annotations

from znicz_tpu_torch.models.samples._vision import flat_image_workflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("hands", {
    "minibatch_size": 40,
    "learning_rate": 0.05,
    "gradient_moment": 0.9,
    "hidden": 30,
    "image_size": 24,
    "max_epochs": 30,
    "validation_fraction": 0.15,
})


def build(**overrides):
    """The sample's workflow from ``root.hands`` updated by
    ``overrides``."""
    cfg = {**root.hands.as_dict(), **overrides}
    return flat_image_workflow("hands", "hands", cfg, n_classes=2,
                               n_images=400, seed=47)


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
