"""ImagenetAE, convolutional autoencoder pretraining at ImageNet
geometry (port of ``znicz_tpu/models/samples/imagenet_ae.py``).

.. code-block:: text

    conv 16 8×8 /4 (tanh) → maxpool 2×2        (216→53→27)
    depooling (tied to the pool) → deconv (tanh, tied to the conv)
                                                (27→53→216)

on 216×216×3 frames, trained by momentum SGD (lr 0.005, moment 0.9) on
minibatches of 64 to reconstruct its input (pixels scaled to [−1, 1]);
the pool's last window is cut at the edge (53 is odd).  The frames are
the reference's stand-in, uint8
:func:`~znicz_tpu_torch.datasets.synthetic_imagenet` (512 train, 64
validation), resident on the device.  At the sample's learning rate
(the reference's) the reconstruction of these noise frames diverges to
the tanh's saturation, in both packages; 5e-5 trains it.  A
``snapshotter_config``, ``lr_adjuster_config`` or ``evaluator_config``
leaf is passed to the workflow::

    python -m znicz_tpu_torch imagenet_ae \\
        --root imagenet_ae.learning_rate=5e-05
    python -m znicz_tpu_torch imagenet_ae -b cpu \\
        --root imagenet_ae.image_size=40 --root imagenet_ae.kx=4 \\
        --root imagenet_ae.ky=4 --root 'imagenet_ae.sliding=(2, 2)'
"""

from __future__ import annotations

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.samples.mnist_ae import WORKFLOW_KEYS, ae_layers
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("imagenet_ae", {
    "minibatch_size": 64,
    "learning_rate": 0.005,
    "gradient_moment": 0.9,
    "image_size": 216,         # divisible through conv 8/4 + pool 2
    "n_kernels": 16,
    "kx": 8,
    "ky": 8,
    "sliding": (4, 4),
    "max_epochs": 10,
    "n_train_samples": 512,
    "n_valid_samples": 64,
})


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.imagenet_ae`` updated by
    ``overrides``."""
    cfg = {**root.imagenet_ae.as_dict(), **overrides}
    wf_kwargs = {k: cfg.pop(k) for k in WORKFLOW_KEYS if k in cfg}
    n_train, n_valid = cfg["n_train_samples"], cfg["n_valid_samples"]
    x, _ = datasets.synthetic_imagenet(n_train + n_valid,
                                       size=cfg["image_size"], n_classes=2)
    wf = StandardWorkflow(
        name="imagenet_ae",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x[:n_train], valid_data=x[n_train:],
            minibatch_size=cfg["minibatch_size"],
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0),
        layers=ae_layers(cfg),
        loss="mse",
        decision_config={"max_epochs": cfg["max_epochs"]},
        **wf_kwargs)
    wf._max_fires = 10 ** 9
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
