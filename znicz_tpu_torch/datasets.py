"""Synthetic datasets (port of the part of ``znicz_tpu/datasets.py``
the AlexNet slice uses)."""

from __future__ import annotations

import numpy as np


def synthetic_imagenet(n_samples: int, size: int = 227,
                       n_classes: int = 1000,
                       seed: int = 44) -> tuple[np.ndarray, np.ndarray]:
    """Throughput stand-in for ImageNet: uint8 NHWC images with uniform
    random content (content does not affect step time), and int32
    labels — the reference's generator, so both packages get the same
    arrays from the same seed."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n_samples, size, size, 3),
                     dtype=np.uint8)
    y = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    return x, y
