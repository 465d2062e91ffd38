"""What the small vision samples share (``hands``, ``yale_faces``,
``channels``): the reference's data-directory test, and the flattened
grayscale classifier of the first two."""

from __future__ import annotations

import os

from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.config import root


def data_dir(name: str) -> str:
    """``root.common.dirs.datasets/<name>``: the sample's real images,
    one subdirectory a class."""
    return os.path.join(str(root.common.dirs.datasets), name)


def refuse_data_dir(sample: str, name: str) -> None:
    """Raise when the sample's real image directory is there: its
    ``FullBatchImageLoader`` branch waits for the image loader (A10)."""
    if os.path.isdir(data_dir(name)):
        raise NotImplementedError(
            f"{sample}: the image directory {data_dir(name)} is read by "
            f"the reference's FullBatchImageLoader, which is not ported "
            f"yet (A10); move it aside to train on the synthetic "
            f"stand-in")


def flat_image_workflow(sample: str, name: str, cfg: dict, n_classes: int,
                        n_images: int, seed: int) -> StandardWorkflow:
    """``image_size``² grayscale images, flattened and scaled to
    [−1, 1], through ``hidden`` (tanh) → ``n_classes`` (softmax), the
    first ``validation_fraction`` held out (the reference's ``hands``
    and ``yale_faces``)."""
    refuse_data_dir(sample, name)
    gd_cfg = {"learning_rate": cfg["learning_rate"],
              "gradient_moment": cfg["gradient_moment"]}
    x, y, _, _ = datasets.synthetic_images(
        n_train=n_images, n_test=0, size=cfg["image_size"], channels=0,
        n_classes=n_classes, seed=seed)
    n_valid = int(len(x) * cfg["validation_fraction"])
    flat = (x.reshape(len(x), -1).astype("float32") / 127.5) - 1.0
    wf = StandardWorkflow(
        name=sample,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=flat[n_valid:], train_labels=y[n_valid:],
            valid_data=flat[:n_valid], valid_labels=y[:n_valid],
            minibatch_size=cfg["minibatch_size"]),
        layers=[
            {"type": "all2all_tanh",
             "->": {"output_sample_shape": cfg["hidden"]}, "<-": gd_cfg},
            {"type": "softmax", "->": {"output_sample_shape": n_classes},
             "<-": gd_cfg},
        ],
        decision_config={"max_epochs": cfg["max_epochs"]})
    wf._max_fires = 10_000_000
    return wf
