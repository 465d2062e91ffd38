"""Sample datasets (port of ``znicz_tpu/datasets.py``).

Each dataset resolves as in the reference: real files under
``root.common.dirs.datasets`` when they are all there (MNIST's idx
files, the CIFAR-10 binary batches, in the reference's formats), or the
UCI sets scikit-learn bundles (Wine, optdigits) when it is installed;
otherwise a procedural stand-in of the same shapes and dtypes with a
learnable class structure.  The readers, the permutation seeds and the
generators are the reference's, copied, so one seed gives the same
bytes in both packages.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from znicz_tpu_torch.utils.config import root


def _dataset_path(*parts: str) -> str:
    return os.path.join(str(root.common.dirs.datasets), *parts)


def _read_idx(path: str) -> np.ndarray:
    """One idx/ubyte file (optionally gzipped) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


_MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def _mnist_paths() -> list[str]:
    """The MNIST files found under ``<datasets>/mnist``, plain or
    gzipped, in :data:`_MNIST_FILES`' order."""
    found = []
    for name in _MNIST_FILES:
        for cand in (_dataset_path("mnist", name),
                     _dataset_path("mnist", name + ".gz")):
            if os.path.exists(cand):
                found.append(cand)
                break
    return found


def load_mnist() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(train_x[60000, 28, 28] u8, train_y, test_x[10000, 28, 28],
    test_y)``: the idx files under ``<datasets>/mnist`` when all four are
    there, else :func:`synthetic_images` of 6000 train and 1000 test
    digits (seed 42), the reference's stand-in."""
    found = _mnist_paths()
    if len(found) == 4:
        return tuple(_read_idx(path) for path in found)
    return synthetic_images(n_train=6000, n_test=1000, size=28,
                            channels=0, n_classes=10, seed=42)


def mnist_is_real() -> bool:
    """True when all four MNIST idx files are there (the condition under
    which :func:`load_mnist` reads them)."""
    return len(_mnist_paths()) == 4


def load_wine() -> tuple[np.ndarray, np.ndarray]:
    """The UCI Wine set (178 × 13, 3 classes) that scikit-learn bundles,
    each feature standardized and the samples permuted (seed 170); the
    same-shape stand-in :func:`_synthetic_wine` when scikit-learn is not
    installed."""
    try:
        from sklearn.datasets import load_wine as _sk_load_wine
    except ImportError:
        return _synthetic_wine()
    bunch = _sk_load_wine()
    data = bunch.data.astype(np.float32)
    data -= data.mean(axis=0)
    data /= data.std(axis=0) + 1e-8
    labels = bunch.target.astype(np.int32)
    order = np.random.default_rng(170).permutation(len(data))
    return data[order], labels[order]


def wine_is_real() -> bool:
    """True when :func:`load_wine` reads the UCI set (scikit-learn is
    installed), False when it gives the stand-in."""
    try:
        import sklearn.datasets  # noqa: F401
    except ImportError:
        return False
    return True


def _synthetic_wine() -> tuple[np.ndarray, np.ndarray]:
    """Three Gaussian classes of 59 samples in 13 dimensions (seed 17)."""
    rng = np.random.default_rng(17)
    centers = rng.normal(0, 1, (3, 13))
    data = np.concatenate([
        c + 0.4 * rng.normal(size=(59, 13)) for c in centers
    ]).astype(np.float32)
    labels = np.repeat(np.arange(3), 59).astype(np.int32)
    order = rng.permutation(len(data))
    return data[order], labels[order]


def load_digits() -> tuple[np.ndarray, np.ndarray]:
    """The optdigits set scikit-learn bundles (1797 × 64, pixels scaled
    to [0, 1], permuted with seed 180); without scikit-learn, 1800
    synthetic 8 × 8 digits (seed 45)."""
    try:
        from sklearn.datasets import load_digits as _sk_load_digits
    except ImportError:
        x, y, _, _ = synthetic_images(n_train=1800, n_test=0, size=8,
                                      channels=0, n_classes=10, seed=45)
        return (x.reshape(len(x), -1).astype(np.float32) / 255.0,
                y.astype(np.int32))
    bunch = _sk_load_digits()
    data = (bunch.data / 16.0).astype(np.float32)
    labels = bunch.target.astype(np.int32)
    order = np.random.default_rng(180).permutation(len(data))
    return data[order], labels[order]


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
