"""ImageSaver: writes the misclassified samples of each epoch to disk
(port of ``znicz_tpu/ops/image_saver.py``): the wrongly classified
samples of the chosen minibatch classes as PNG files named by their
true and predicted labels, for a human to look at what the net gets
wrong.

A host unit after the decision (``StandardWorkflow.link_image_saver``),
so it runs after every step: it reads the minibatch's data, labels,
sample indices and the head's argmax back from the device and writes
the offending samples under ``root.common.dirs.images/<workflow>/
epoch_<N>/``, at most ``limit`` an epoch.  It needs every minibatch, so
``StandardWorkflow.run_chunked`` runs step by step when one is linked
(``NEEDS_PER_STEP_MINIBATCHES``).

The PNGs (8-bit grayscale, mode L, or RGB) are written by
:func:`write_png`, a small encoder on ``zlib`` and ``struct``: the
card's machine has no imaging library.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib

import numpy as np

from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.ops.nn_units import to_host
from znicz_tpu_torch.units import Unit
from znicz_tpu_torch.utils.config import root

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """``img`` (uint8, H×W: mode L, or H×W×3: RGB) as a PNG file: one
    IDAT chunk of zlib-compressed rows, each with filter type 0."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png: an H×W or H×W×3 image, got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    data = (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def to_image_array(sample: np.ndarray) -> np.ndarray:
    """One sample as a uint8 H×W or H×W×3 image (the reference's,
    copied)."""
    img = np.asarray(sample, dtype=np.float32)
    if img.ndim == 1:  # a flat vector → square if possible
        side = int(np.sqrt(img.size))
        if side * side == img.size:
            img = img.reshape(side, side)
        else:
            img = img.reshape(1, -1)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 3 and img.shape[-1] not in (3,):
        img = img[..., :1][..., 0]  # the first channel as grayscale
    lo, hi = float(img.min()), float(img.max())
    if hi > lo:
        img = (img - lo) / (hi - lo)
    else:  # a constant sample: flat mid-gray, not a wrapped uint8 cast
        img = np.full_like(img, 0.5)
    return (img * 255.0 + 0.5).astype(np.uint8)


class ImageSaver(Unit):
    """Saves the misclassified samples (every sample with ``save_all``)
    of the minibatch classes in ``classes``.

    A file is ``<sample>_t<true>_p<pred>.png`` in
    ``out_dir/epoch_<epoch>/``; at most ``limit`` files an epoch (the
    epoch's directory is emptied when the epoch's first file is
    written).
    """

    NEEDS_PER_STEP_MINIBATCHES = True

    def __init__(self, workflow=None, name: str | None = None,
                 out_dir: str | None = None, limit: int = 64,
                 save_all: bool = False, classes=(1, 0),
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        wf_name = workflow.name if workflow is not None else "wf"
        self.out_dir = out_dir or os.path.join(
            str(root.common.dirs.images), wf_name)
        self.limit = int(limit)
        self.save_all = save_all
        self.classes = tuple(classes)  # the minibatch classes to inspect
        # linked (StandardWorkflow.link_image_saver wires them)
        self.input = None               # loader.minibatch_data
        self.labels = None              # loader.minibatch_labels
        self.max_idx = None             # the softmax's argmax
        self.indices = None             # loader.minibatch_indices
        self.minibatch_class = TRAIN
        self.minibatch_valid = None
        self.epoch_number = 0           # linked from the loader
        self._saved_this_epoch = 0
        self._last_epoch = -1

    def _epoch_dir(self) -> str:
        d = os.path.join(self.out_dir, f"epoch_{int(self.epoch_number)}")
        if self._last_epoch != int(self.epoch_number):
            self._last_epoch = int(self.epoch_number)
            self._saved_this_epoch = 0
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)
        return d

    def run(self) -> None:
        if int(self.minibatch_class) not in self.classes:
            return
        if self._saved_this_epoch >= self.limit \
                and self._last_epoch == int(self.epoch_number):
            return
        data = to_host(self.input)
        truth = to_host(self.labels)
        pred = to_host(self.max_idx)
        n_valid = (int(self.minibatch_valid)
                   if self.minibatch_valid is not None else data.shape[0])
        sample_ids = (to_host(self.indices) if self.indices is not None
                      else np.arange(data.shape[0]))
        wrong = np.nonzero((truth[:n_valid] != pred[:n_valid])
                           if not self.save_all
                           else np.ones(n_valid, dtype=bool))[0]
        if wrong.size == 0:
            return
        out = self._epoch_dir()
        for i in wrong:
            if self._saved_this_epoch >= self.limit:
                break
            path = os.path.join(
                out, f"{int(sample_ids[i])}_t{int(truth[i])}"
                     f"_p{int(pred[i])}.png")
            write_png(path, to_image_array(data[i]))
            self._saved_this_epoch += 1
