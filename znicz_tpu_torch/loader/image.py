"""Image loaders: directory datasets, decode and augment, streamed or
resident (port of ``znicz_tpu/loader/image.py``).

The decode and augment is the native worker pool
(:mod:`znicz_tpu_torch.native`: the package's own JPEG and PNG
decoders, which give the reference pool's libjpeg/libpng bytes and link
only zlib; bilinear resize, crop/flip), double-buffered: the pool
decodes batch N+1 on the host's cores while the device computes batch
N.  ``use_native``:

- ``True``: the pool, or an error carrying its build error;
- ``False``: PIL (imported when it decodes, so the package imports on a
  machine without it);
- ``None`` (the default): on the CPU the pool if it builds, else PIL,
  as in the reference; **on a CUDA device it means True**: the pool is
  the card's only decoder, a pool that cannot build there raises, and
  no card quietly decodes with PIL.  :attr:`ImageLoader.decoder`
  records which decoder ran.

Two modes:

- :class:`ImageLoader` / :class:`FileImageLoader` stream: each step's
  files decode into a host buffer (page-locked on the card), as raw
  uint8 pixels, and the batch reaches the fixed ``minibatch_raw`` tensor
  in place (an asynchronous copy on the compute stream,
  :meth:`~znicz_tpu_torch.loader.base.StagedLoader.deliver`); the
  affine normalize runs in the region.  A buffer is decoded into again
  only once its copy to the card has run (an event).  For datasets
  larger than the card's memory (ImageNet).
- :class:`FullBatchImageLoader` decodes everything once into the
  resident full-batch store; a minibatch is an on-device gather.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from znicz_tpu_torch.loader.base import TEST, TRAIN, VALID, StagedLoader
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
from znicz_tpu_torch.memory import host_buffer
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.utils import prng

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


def scan_directory(directory: str,
                   label_map: dict[str, int] | None = None
                   ) -> tuple[list[str], list[int], dict[str, int]]:
    """Class-per-subdirectory scan: ``(paths, labels, label_map)``.  A
    flat directory (no subdirectories) gives label 0 and does not claim
    the label map: a later split with class subdirectories may still
    build it."""
    subdirs = sorted(
        d for d in os.listdir(directory)
        if os.path.isdir(os.path.join(directory, d)))
    paths: list[str] = []
    labels: list[int] = []
    if not subdirs:
        files = sorted(
            f for f in os.listdir(directory)
            if f.lower().endswith(IMAGE_EXTENSIONS))
        for f in files:
            paths.append(os.path.join(directory, f))
            labels.append(0)
        return paths, labels, label_map
    if label_map is None:
        label_map = {d: i for i, d in enumerate(subdirs)}
    for d in subdirs:
        if d not in label_map:
            raise ValueError(f"class dir '{d}' missing from label map")
        full = os.path.join(directory, d)
        for f in sorted(os.listdir(full)):
            if f.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(os.path.join(full, f))
                labels.append(label_map[d])
    return paths, labels, label_map


def carve_validation(paths: list[str], labels: list[int],
                     fraction: float, rnd
                     ) -> tuple[tuple[list[str], list[int]],
                                tuple[list[str], list[int]]]:
    """Split a train file list into ``(valid, train)`` by a seeded
    permutation drawn from ``rnd``."""
    n_valid = int(len(paths) * fraction)
    perm = rnd.permutation(len(paths))
    v_idx, t_idx = perm[:n_valid], perm[n_valid:]
    return (([paths[i] for i in v_idx], [labels[i] for i in v_idx]),
            ([paths[i] for i in t_idx], [labels[i] for i in t_idx]))


def _decode_pil(path: str, out_hw: tuple[int, int],
                resize_hw: tuple[int, int] | None, channels: int,
                random_crop: bool, random_flip: bool,
                scale: float, bias: float,
                rng: np.random.Generator) -> np.ndarray:
    """The PIL decode, with the native pool's semantics (bilinear
    resize → crop → optional flip → affine); a file that fails to
    decode gives zeros."""
    from PIL import Image

    out_h, out_w = out_hw
    blank_shape = (out_h, out_w) if channels == 1 else (out_h, out_w, 3)
    try:
        img = Image.open(path).convert("RGB")
    except Exception:
        return np.zeros(blank_shape, dtype=np.float32)
    if resize_hw is not None:
        rh, rw = resize_hw
        img = img.resize((rw, rh), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32)
    max_dy = arr.shape[0] - out_h
    max_dx = arr.shape[1] - out_w
    if max_dy < 0 or max_dx < 0:
        return np.zeros(blank_shape, dtype=np.float32)
    if random_crop:
        dy = int(rng.integers(0, max_dy + 1))
        dx = int(rng.integers(0, max_dx + 1))
    else:
        dy, dx = max_dy // 2, max_dx // 2
    arr = arr[dy:dy + out_h, dx:dx + out_w]
    if random_flip and rng.integers(0, 2):
        arr = arr[:, ::-1]
    if channels == 1:
        arr = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
               + 0.114 * arr[..., 2])
    return arr * scale + bias


def _resolve_native(use_native: bool | None, device) -> bool:
    """``use_native`` with None resolved: True on a CUDA device, else
    whether the pool builds."""
    if use_native is not None:
        return bool(use_native)
    if device.type == "cuda":
        return True
    from znicz_tpu_torch.native import ImagePipeline
    return ImagePipeline.available()


class ImageLoader(StagedLoader):
    """The streaming image loader.

    Subclasses (or :class:`FileImageLoader`) give ``file_paths`` in
    global-index order (test, validation, train) and ``file_labels``.
    Each step decodes the scheduled files into a host buffer (NHWC, or
    NHW when ``grayscale``) as raw uint8 pixels, delivered in place into
    ``minibatch_raw``; train minibatches get random crops and flips,
    the others center crops.  With ``prefetch`` the pool decodes the
    next step's files into the other of two buffers while the device
    works, the next epoch's first minibatch included (its order is
    decided before it starts).
    """

    def __init__(self, workflow, name: str | None = None,
                 out_hw: tuple[int, int] = (227, 227),
                 resize_hw: tuple[int, int] | None = (256, 256),
                 grayscale: bool = False,
                 random_crop: bool = True,
                 random_flip: bool = True,
                 normalization_scale: float = 1.0 / 127.5,
                 normalization_bias: float = -1.0,
                 n_threads: int = 0,
                 prefetch: bool = True,
                 use_native: bool | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name,
                         normalization_scale=float(normalization_scale),
                         normalization_bias=float(normalization_bias),
                         **kwargs)
        self.out_hw = tuple(out_hw)
        self.resize_hw = None if resize_hw is None else tuple(resize_hw)
        self.grayscale = bool(grayscale)
        self.random_crop = bool(random_crop)
        self.random_flip = bool(random_flip)
        self.n_threads = n_threads
        self.prefetch = bool(prefetch)
        self.use_native = use_native
        #: "native" or "pil", once initialized
        self.decoder: str | None = None
        self.file_paths: list[str] = []
        self.file_labels: list[int] = []
        self._pipe = None
        #: the decode buffers and their meta rows (page-locked on the
        #: card): the pool fills one while the device reads the other
        self._decode_bufs: list[tuple[torch.Tensor, np.ndarray]] = []
        self._metas: list[tuple[torch.Tensor, np.ndarray]] = []
        #: per buffer, the event after its copy to the card
        self._copied: list = []
        self._decode_buf = 0
        self._pending: tuple[int, int] | None = None  # (epoch, cursor)
        self._pil_rng = np.random.default_rng(1)
        self._seed_base: int | None = None
        # the overlap counters (the metrics registry has them too)
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_wait_s = 0.0
        self.epoch_cross_prefetches = 0

    def load_data(self) -> None:
        if not self.file_paths:
            raise ValueError(f"{self}: no file paths provided")
        if len(self.file_paths) != len(self.file_labels):
            raise ValueError(f"{self}: paths/labels length mismatch")

    @property
    def channels(self) -> int:
        return 1 if self.grayscale else 3

    @property
    def sample_shape(self) -> tuple[int, ...]:
        h, w = self.out_hw
        return (h, w) if self.grayscale else (h, w, 3)

    @property
    def raw_dtype(self) -> np.dtype:
        return np.dtype(np.uint8)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        native = _resolve_native(self.use_native, self.device)
        self._pipe = None
        if native:
            # raises, carrying the build error, when the pool cannot
            # build (on the card: use_native None means True)
            from znicz_tpu_torch.native import ImagePipeline
            self._pipe = ImagePipeline(self.n_threads)
        self.decoder = "native" if native else "pil"
        cuda = self.device.type == "cuda"
        n_bufs = 2 if (native and self.prefetch) else 1
        shape = (self.local_rows,) + self.sample_shape
        self._decode_bufs = [host_buffer(shape, np.uint8, cuda)
                         for _ in range(n_bufs)]
        self._metas = [host_buffer((self.meta_len,), np.int64, cuda)
                       for _ in range(n_bufs)]
        self._copied = [torch.cuda.Event() if cuda else None
                        for _ in range(n_bufs)]
        self._decode_buf = 0
        self._pending = None
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_wait_s = 0.0
        self.epoch_cross_prefetches = 0
        if _metrics.enabled():
            # the decode double-buffer: one batch in flight
            _metrics.prefetch_depth(self.name).set(
                1 if (self.prefetch and native) else 0)
        self._pil_rng = np.random.default_rng(
            prng.get().randint(0, 2 ** 31))

    def stop(self) -> None:
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None
        super().stop()

    # -- the decode ---------------------------------------------------------
    def _augment_flags(self, minibatch_class: int) -> tuple[bool, bool]:
        train = minibatch_class == TRAIN
        return (self.random_crop and train, self.random_flip and train)

    def _local(self, idx: np.ndarray) -> np.ndarray:
        """This process's block of a minibatch's indices."""
        rows = self.local_rows
        rank = self.device.data_rank
        return idx[rank * rows:(rank + 1) * rows]

    def _ready(self, buf: int) -> None:
        """Wait until the last copy out of buffer ``buf`` has run."""
        event = self._copied[buf]
        if event is not None:
            event.synchronize()

    def _submit(self, idx: np.ndarray, minibatch_class: int,
                out: np.ndarray, seed: int) -> None:
        crop, flip = self._augment_flags(minibatch_class)
        paths = [self.file_paths[i] for i in idx]
        self._pipe.submit(
            paths, out, out_hw=self.out_hw, resize_hw=self.resize_hw,
            channels=self.channels, random_crop=crop, random_flip=flip,
            seed=seed)  # raw uint8; the normalize runs in the region

    def _decode_sync(self, idx: np.ndarray, minibatch_class: int,
                     out: np.ndarray, seed: int) -> None:
        if self._pipe is not None:
            self._submit(idx, minibatch_class, out, seed)
            n_failed = self._pipe.wait()
            if n_failed:
                self.warning("%d failed decodes (zero-filled)", n_failed)
            return
        crop, flip = self._augment_flags(minibatch_class)
        for row, i in enumerate(idx):
            out[row] = np.rint(_decode_pil(
                self.file_paths[i], self.out_hw, self.resize_hw,
                self.channels, crop, flip, 1.0, 0.0,
                self._pil_rng)).astype(np.uint8)

    def _peek_next(self) -> tuple[np.ndarray, int, tuple[int, int]]:
        """Indices, class and ``(epoch, cursor)`` of the next schedule
        entry, across the epoch's end too."""
        if self._cursor < len(self._schedule):
            pos = (self.epoch_number, self._cursor)
        else:
            pos = (self.epoch_number + 1, 0)
        idx, cls, _count = self.schedule_entry(*pos)
        return self._local(idx), cls, pos

    def _decode_seed(self, epoch: int, cursor: int) -> int:
        return (int(self._seed_base) + epoch * 1_000_003 + cursor) \
            & (2 ** 63 - 1)

    def host_run(self) -> None:
        if self._seed_base is None:
            # drawn at the first step, as the reference draws it
            self._seed_base = prng.get().randint(0, 2 ** 31)
        super().host_run()  # the schedule's bookkeeping
        cur = (self.epoch_number, self._cursor - 1)
        gidx, _cls, count = self.schedule_entry(*cur)
        idx = self._local(gidx)
        buf = self._decode_buf
        if self._pipe is not None and self.prefetch \
                and self._pending == cur:
            with _tracing.TRACER.span(f"input_wait:{self.name}",
                                      cat="loader"):
                t0 = time.perf_counter()
                n_failed = self._pipe.wait()
                waited = time.perf_counter() - t0
            self.prefetch_wait_s += waited
            self.prefetch_hits += 1
            crossed = cur[1] == 0 and cur[0] > 0
            if crossed:
                self.epoch_cross_prefetches += 1
            if _metrics.enabled():
                _metrics.input_wait_seconds(self.name).observe(waited)
                _metrics.loader_prefetch(self.name, "hit").inc()
                if crossed:
                    _metrics.loader_prefetch(self.name,
                                             "epoch_cross").inc()
            if n_failed:
                self.warning("%d failed decodes (zero-filled)", n_failed)
        else:
            if self._pipe is not None:
                self.prefetch_misses += 1
                if self._pending is not None:
                    # a prefetch for another position (a resume): drain
                    self._pipe.wait()
            t0 = time.perf_counter()
            self._ready(buf)
            self._decode_sync(idx, self.minibatch_class,
                              self._decode_bufs[buf][1],
                              self._decode_seed(*cur))
            if _metrics.enabled() and self._pipe is not None:
                # a synchronous decode is input time the step waits
                _metrics.input_wait_seconds(self.name).observe(
                    time.perf_counter() - t0)
                _metrics.loader_prefetch(self.name, "miss").inc()
        self._pending = None
        meta = self._metas[buf][1]
        self.fill_meta(meta, count, idx, np.asarray(
            [self.file_labels[i] for i in idx], dtype=np.int64))
        self.deliver(self._decode_bufs[buf][0], self._metas[buf][0])
        if self._copied[buf] is not None:
            self._copied[buf].record()
        # queue the next step's decode now: the pool works on N+1 while
        # the device computes N
        if self._pipe is not None and self.prefetch:
            nidx, ncls, pos = self._peek_next()
            self._decode_buf = nxt = 1 - buf
            self._ready(nxt)
            self._submit(nidx, ncls, self._decode_bufs[nxt][1],
                         self._decode_seed(*pos))
            self._pending = pos


class FileImageLoader(ImageLoader):
    """A directory-tree image dataset: one directory a split, one
    subdirectory a class.  ``validation_fraction`` carves a validation
    split off the train directory when there is no validation
    directory."""

    def __init__(self, workflow,
                 train_dir: str,
                 valid_dir: str | None = None,
                 test_dir: str | None = None,
                 validation_fraction: float = 0.0,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.train_dir = train_dir
        self.valid_dir = valid_dir
        self.test_dir = test_dir
        self.validation_fraction = float(validation_fraction)

    def load_data(self) -> None:
        train_paths, train_labels, label_map = \
            scan_directory(self.train_dir)
        splits: dict[int, tuple[list[str], list[int]]] = {
            TRAIN: (train_paths, train_labels), VALID: ([], []),
            TEST: ([], [])}
        if self.valid_dir is not None:
            # a flat train directory leaves the map None: the first
            # classed split builds it
            vp, vl, label_map = scan_directory(self.valid_dir, label_map)
            splits[VALID] = (vp, vl)
        elif self.validation_fraction > 0:
            splits[VALID], splits[TRAIN] = carve_validation(
                train_paths, train_labels, self.validation_fraction,
                prng.get())
        if self.test_dir is not None:
            tp, tl, label_map = scan_directory(self.test_dir, label_map)
            splits[TEST] = (tp, tl)
        self.label_map = label_map or {}
        self.file_paths = []
        self.file_labels = []
        for cls in (TEST, VALID, TRAIN):  # global index order
            p, l = splits[cls]
            self.class_lengths[cls] = len(p)
            self.file_paths += p
            self.file_labels += l
        super().load_data()


class FullBatchImageLoader(FullBatchLoader):
    """The whole image dataset decoded once (center crops, no
    augmentation) into the resident full-batch store, float32; a
    minibatch is an on-device gather."""

    def __init__(self, workflow,
                 train_dir: str,
                 valid_dir: str | None = None,
                 test_dir: str | None = None,
                 validation_fraction: float = 0.0,
                 out_hw: tuple[int, int] = (32, 32),
                 resize_hw: tuple[int, int] | None = None,
                 grayscale: bool = False,
                 n_threads: int = 0,
                 use_native: bool | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.train_dir = train_dir
        self.valid_dir = valid_dir
        self.test_dir = test_dir
        self.validation_fraction = float(validation_fraction)
        self.out_hw = tuple(out_hw)
        self.resize_hw = None if resize_hw is None else tuple(resize_hw)
        self.grayscale = bool(grayscale)
        self.n_threads = n_threads
        self.use_native = use_native
        #: "native" or "pil", once the data is loaded
        self.decoder: str | None = None

    def load_data(self) -> None:
        label_map: dict[str, int] | None = None
        dirs = {TEST: self.test_dir, VALID: self.valid_dir,
                TRAIN: self.train_dir}
        splits: dict[int, tuple[list[str], list[int]]] = {}
        # the train directory owns the label map; the others conform
        for cls in (TRAIN, VALID, TEST):
            d = dirs[cls]
            if d is None:
                splits[cls] = ([], [])
                continue
            p, l, label_map = scan_directory(d, label_map)
            splits[cls] = (p, l)
        if self.valid_dir is None and self.validation_fraction > 0:
            tp, tl = splits[TRAIN]
            splits[VALID], splits[TRAIN] = carve_validation(
                tp, tl, self.validation_fraction, prng.get())
        paths: list[str] = []
        labels: list[int] = []
        for cls in (TEST, VALID, TRAIN):  # global index order
            p, l = splits[cls]
            self.class_lengths[cls] = len(p)
            paths += p
            labels += l
        if not paths:
            raise ValueError(f"{self}: no images found")
        h, w = self.out_hw
        channels = 1 if self.grayscale else 3
        shape = (len(paths), h, w) if self.grayscale \
            else (len(paths), h, w, 3)
        data = np.zeros(shape, dtype=np.float32)
        native = _resolve_native(self.use_native, self.device)
        if native:
            from znicz_tpu_torch.native import ImagePipeline
            pipe = ImagePipeline(self.n_threads)
            try:
                pipe.submit(paths, data, out_hw=self.out_hw,
                            resize_hw=self.resize_hw, channels=channels)
                n_failed = pipe.wait()
            finally:
                pipe.close()
            if n_failed:
                self.warning("%d failed decodes (zero-filled)", n_failed)
        else:
            rng = np.random.default_rng(0)
            for i, p in enumerate(paths):
                data[i] = _decode_pil(
                    p, self.out_hw, self.resize_hw, channels,
                    False, False, 1.0, 0.0, rng)
        self.decoder = "native" if native else "pil"
        self.original_data = torch.from_numpy(data)
        self.original_labels = torch.from_numpy(
            np.asarray(labels, dtype=np.int32))


__all__ = ["ImageLoader", "FileImageLoader", "FullBatchImageLoader",
           "scan_directory", "carve_validation", "IMAGE_EXTENSIONS"]
