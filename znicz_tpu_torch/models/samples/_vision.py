"""What the small vision samples share (``hands``, ``yale_faces``,
``channels``): the loader of the sample's real image directory, when
there is one (:class:`~znicz_tpu_torch.loader.image.
FullBatchImageLoader`, as in the reference), and the flattened
grayscale classifier of the first two."""

from __future__ import annotations

import os

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.loader.image import FullBatchImageLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import root


def data_dir(name: str) -> str:
    """``root.common.dirs.datasets/<name>``: the sample's real images,
    one subdirectory a class."""
    return os.path.join(str(root.common.dirs.datasets), name)


def image_dir_loader(name: str, cfg: dict, grayscale: bool):
    """A loader factory over the sample's real image directory (one
    subdirectory a class, decoded once into the resident store at
    ``image_size``², scaled to [−1, 1], the first
    ``validation_fraction`` carved off for validation), or None when
    there is no directory."""
    directory = data_dir(name)
    if not os.path.isdir(directory):
        return None
    size = cfg["image_size"]
    return lambda w: FullBatchImageLoader(
        w, train_dir=directory,
        validation_fraction=cfg["validation_fraction"],
        out_hw=(size, size), resize_hw=None, grayscale=grayscale,
        normalization_scale=2.0 / 255.0, normalization_bias=-1.0,
        minibatch_size=cfg["minibatch_size"])


def flat_image_workflow(sample: str, name: str, cfg: dict, n_classes: int,
                        n_images: int, seed: int) -> StandardWorkflow:
    """``image_size``² grayscale images (the sample's directory, else
    the synthetic stand-in, flattened), scaled to [−1, 1], through ``hidden`` (tanh) → ``n_classes`` (softmax), the
    first ``validation_fraction`` held out (the reference's ``hands``
    and ``yale_faces``)."""
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"]}
    loader_factory = image_dir_loader(name, cfg, grayscale=True)
    if loader_factory is None:
        x, y, _, _ = datasets.synthetic_images(
            n_train=n_images, n_test=0, size=cfg["image_size"], channels=0,
            n_classes=n_classes, seed=seed)
        n_valid = int(len(x) * cfg["validation_fraction"])
        flat = (x.reshape(len(x), -1).astype("float32") / 127.5) - 1.0
        loader_factory = lambda w: ArrayLoader(  # noqa: E731
            w, train_data=flat[n_valid:], train_labels=y[n_valid:],
            valid_data=flat[:n_valid], valid_labels=y[:n_valid],
            minibatch_size=cfg["minibatch_size"])
    wf = StandardWorkflow(
        name=sample,
        loader_factory=loader_factory,
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": cfg["hidden"]}, "<-": gd_cfg},
            {"type": "softmax", "->": {"output_sample_shape": n_classes},
             "<-": gd_cfg},
        ],
        decision_config={"max_epochs": cfg["max_epochs"]})
    wf._max_fires = 10_000_000
    return wf
