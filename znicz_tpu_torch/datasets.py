"""Sample datasets (port of the part of ``znicz_tpu/datasets.py`` the
AlexNet and CIFAR-10 samples use).

Each dataset resolves as in the reference: real files under
``root.common.dirs.datasets`` when they are all there (the CIFAR-10
binary batches, in the reference's format), otherwise a procedural
stand-in of the same shapes and dtypes with a learnable class
structure.  The generators are the reference's, copied, so one seed
gives the same bytes in both packages.
"""

from __future__ import annotations

import os

import numpy as np

from znicz_tpu_torch.utils.config import root


def _dataset_path(*parts: str) -> str:
    return os.path.join(str(root.common.dirs.datasets), *parts)


def load_cifar10() -> tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray]:
    """``(train_x[N, 32, 32, 3] u8, train_y, test_x, test_y)``: the
    binary batches under ``<datasets>/cifar-10-batches-bin`` when all
    six are present, else :func:`synthetic_images` of 5000 train and
    1000 test images (seed 43), the reference's stand-in."""
    base = _dataset_path("cifar-10-batches-bin")
    batch_names = [f"data_batch_{i}.bin" for i in range(1, 6)]
    if all(os.path.exists(os.path.join(base, b))
           for b in batch_names + ["test_batch.bin"]):
        xs, ys = [], []
        for b in batch_names + ["test_batch.bin"]:
            raw = np.fromfile(os.path.join(base, b), dtype=np.uint8)
            raw = raw.reshape(-1, 3073)
            ys.append(raw[:, 0].astype(np.int32))
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                      .transpose(0, 2, 3, 1))  # → NHWC
        return np.concatenate(xs[:5]), np.concatenate(ys[:5]), xs[5], ys[5]
    return synthetic_images(n_train=5000, n_test=1000, size=32,
                            channels=3, n_classes=10, seed=43)


def synthetic_images(n_train: int, n_test: int, size: int, channels: int,
                     n_classes: int, seed: int, dtype=np.uint8,
                     noise: float = 64.0) -> tuple[np.ndarray, np.ndarray,
                                                   np.ndarray, np.ndarray]:
    """Class-prototype images plus Gaussian noise of sigma ``noise``,
    ``(train_x, train_y, test_x, test_y)``; ``channels=0`` gives
    ``(N, size, size)`` grayscale."""
    rng = np.random.default_rng(seed)
    shape = (size, size) if channels == 0 else (size, size, channels)
    protos = rng.uniform(0, 255, size=(n_classes,) + shape)

    def make(n: int):
        per = n // n_classes
        xs, ys = [], []
        for c in range(n_classes):
            xs.append(np.clip(
                protos[c] + rng.normal(0, noise, size=(per,) + shape),
                0, 255))
            ys.append(np.full(per, c, dtype=np.int32))
        x = np.concatenate(xs).astype(dtype)
        y = np.concatenate(ys)
        order = rng.permutation(len(x))
        return x[order], y[order]

    train_x, train_y = make(n_train)
    test_x, test_y = make(n_test)
    return train_x, train_y, test_x, test_y


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
