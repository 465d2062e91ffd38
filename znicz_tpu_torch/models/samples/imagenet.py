"""ImageNet from disk: AlexNet over the streaming image pipeline (port of
``znicz_tpu/models/samples/imagenet.py``).

Point ``root.imagenet.train_dir`` at a class-per-subdirectory image
tree (the standard ImageNet layout); ``valid_dir`` is optional (else
``validation_fraction`` carves one off the train tree).  The loader is
:class:`~znicz_tpu_torch.loader.image.FileImageLoader` on the native
decode pool: resize to 256, random 227 crops and horizontal flips on
train, center crops on evaluation, double-buffered so the decode of
batch N+1 overlaps the device's step on batch N.  On the card the pool
must build (``use_native`` None means True there), or the loader
raises with its build error.  The layers are :mod:`.alexnet`'s::

    python -m znicz_tpu_torch imagenet --root imagenet.train_dir=<tree>
"""

from __future__ import annotations

from znicz_tpu_torch.loader.image import FileImageLoader
from znicz_tpu_torch.models.samples.alexnet import layers
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("imagenet", {
    "train_dir": None,           # required: the ImageNet train tree
    "valid_dir": None,
    "validation_fraction": 0.04,
    "minibatch_size": 128,
    "learning_rate": 0.01,
    "gradient_moment": 0.9,
    "weights_decay": 0.0005,
    "dropout": 0.5,
    "n_classes": 1000,
    "max_epochs": 90,
    "image_size": 227,
    "resize_size": 256,
    "decode_threads": 0,         # 0: the host's hardware concurrency
})


def build(**overrides) -> StandardWorkflow:
    """The sample's workflow from ``root.imagenet`` updated by
    ``overrides``."""
    cfg = {**root.imagenet.as_dict(), **overrides}
    if not cfg["train_dir"]:
        raise ValueError(
            "root.imagenet.train_dir must point at an ImageNet-layout "
            "image tree (class-per-subdirectory)")
    size = int(cfg["image_size"])
    resize = int(cfg["resize_size"])
    wf_kwargs = {k: cfg.pop(k) for k in ("snapshotter_config",
                                         "lr_adjuster_config",
                                         "evaluator_config")
                 if k in cfg}
    wf = StandardWorkflow(
        name="imagenet",
        loader_factory=lambda w: FileImageLoader(
            w, train_dir=cfg["train_dir"], valid_dir=cfg["valid_dir"],
            validation_fraction=cfg["validation_fraction"],
            out_hw=(size, size), resize_hw=(resize, resize),
            random_crop=True, random_flip=True,
            normalization_scale=2.0 / 255.0, normalization_bias=-1.0,
            minibatch_size=cfg["minibatch_size"],
            n_threads=cfg["decode_threads"]),
        layers=layers(cfg),
        decision_config={"max_epochs": cfg["max_epochs"]},
        **wf_kwargs)
    wf._max_fires = 10 ** 9
    return wf


def run(load, main):
    """The reference's sample protocol (``veles <sample> <config>``)."""
    load(build)
    main()
