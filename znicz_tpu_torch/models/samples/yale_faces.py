"""YaleFaces, the small face-recognition demo (port of
``znicz_tpu/models/samples/yale_faces.py``).

Grayscale 32×32 faces of 15 subjects, flattened, through
1024 → 100 (tanh) → 15 (softmax), trained by momentum SGD (lr 0.02,
moment 0.9) on minibatches of 20, 15 % of the images held out for
validation.  With no ``root.common.dirs.datasets/yalefaces`` directory
the data is the reference's stand-in: 11 images a subject of
:func:`~znicz_tpu_torch.datasets.synthetic_images` (seed 46) scaled to
[−1, 1].  A real directory (one subdirectory per subject, read by the
reference's ``FullBatchImageLoader``) waits for the image loader (A10)
and raises::

    python -m znicz_tpu_torch yale_faces -b cpu
"""

from __future__ import annotations

from znicz_tpu_torch.models.samples._vision import flat_image_workflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("yale_faces", {
    "minibatch_size": 20,
    "learning_rate": 0.02,
    "gradient_moment": 0.9,
    "hidden": 100,
    "n_subjects": 15,
    "image_size": 32,
    "max_epochs": 40,
    "validation_fraction": 0.15,
})


def build(**overrides):
    """The sample's workflow from ``root.yale_faces`` updated by
    ``overrides``."""
    cfg = {**root.yale_faces.as_dict(), **overrides}
    return flat_image_workflow("yale_faces", "yalefaces", cfg,
                               n_classes=cfg["n_subjects"],
                               n_images=cfg["n_subjects"] * 11, seed=46)


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
