"""Loader base: the minibatch schedule (port of
``znicz_tpu/loader/base.py``).

- three sample classes ``TEST=0 / VALID=1 / TRAIN=2`` with
  ``class_lengths``; one epoch walks every non-empty class in order
  (test, validation, train), so the decision unit can count errors per
  class;
- the train indices are reshuffled every epoch, counter-based: epoch
  *e*'s order is :func:`epoch_permutation` of ``(shuffle_seed, e)``
  (numpy's Philox, copied from the reference, so the same seed gives
  the same order bit for bit in both packages); ``shuffle_limit``
  freezes the order after that many epochs.  Any epoch's order is a
  pure function of the seed (:meth:`Loader.train_order`,
  :meth:`Loader.schedule_entry`), so a prefetcher (the streaming
  loader's producer, the image loader's decode look-ahead) computes a
  future epoch's minibatches without replaying the past;
- the last minibatch of a class is padded to the fixed minibatch size
  by repeating its first sample, and ``minibatch_size`` carries the
  true count so the evaluator masks the tail;
- flags read by the decision unit: ``minibatch_class``,
  ``epoch_ended``, ``epoch_number``;
- ``forward_mode``: "train" on train minibatches, "eval" otherwise,
  linked (one way) into the stochastic units (dropout), as the
  reference links it;
- on a device with a mesh (data parallelism) the bookkeeping stays
  global: every process draws the same order from the same seed and
  picks the same minibatch, and the gather takes only this process's
  block of its rows (``max_minibatch_size // n_data_shards`` of them,
  the reference's ``put_local_batch``).  ``minibatch_valid`` stays the
  global count, so the evaluator normalizes by the global batch.  The
  minibatch is clamped down to a multiple of the data shards, and one
  that cannot be sharded at all raises, as in the reference.

A loader is a unit.  The index picking is host work
(:meth:`Loader.host_run`, which the workflow's graph fires before the
region); the gather is the unit's device work, which runs in the
training step's region (:mod:`znicz_tpu_torch.loader.fullbatch`).  A
:class:`StagedLoader` (the streaming and image loaders) reads its batch
on the host instead and delivers it into fixed device tensors before
the step; its device work is the affine normalize.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.mutable import Bool
from znicz_tpu_torch.utils import prng

TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAME = {TEST: "test", VALID: "validation", TRAIN: "train"}

_U64 = (1 << 64) - 1


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """A permutation of ``n`` as a pure function of ``(seed, epoch)``
    through the Philox counter-based generator (the reference's, copied
    verbatim)."""
    gen = np.random.Generator(np.random.Philox(
        key=np.array([seed & _U64, epoch & _U64], dtype=np.uint64)))
    return gen.permutation(n).astype(np.int32)


def normalization_table(scale: float, bias: float, dtype: torch.dtype,
                        device) -> torch.Tensor:
    """The 256 normalized values a uint8 pixel can take: the product and
    the sum in f64 (both exact), rounded once to f32 and once to
    ``dtype``, as the reference's fused multiply-add rounds them."""
    table = (np.arange(256, dtype=np.float64) * np.float32(scale)
             + np.float32(bias))
    return torch.from_numpy(table.astype(np.float32)).to(dtype).to(device)


def normalize(batch: torch.Tensor, table: torch.Tensor | None,
              scale: float | None, bias: float,
              dtype: torch.dtype) -> torch.Tensor:
    """``batch·scale + bias`` at ``dtype``: a look-up in ``table`` for
    uint8 pixels, else in f32; no normalization when ``scale`` is
    None."""
    if table is not None:
        batch = table.index_select(0, batch.reshape(-1).int()).view(
            batch.shape)
    elif scale is not None:
        batch = (batch.float() * float(np.float32(scale))
                 + float(np.float32(bias)))
    return batch.to(dtype)


class Loader(AcceleratedUnit):
    """Abstract minibatch provider.

    Subclasses implement :meth:`load_data` (set ``class_lengths`` and
    the storage), :meth:`create_minibatch_data` and the gather
    (``device_run``).
    """

    #: True for a loader whose schedule lives on the device, so that a
    #: region step finds its minibatch itself (a run in chunks needs it)
    device_schedule = False
    #: schedule state a snapshot carries (the reference's names)
    SNAPSHOT_ATTRS = ("epoch_number", "_cursor", "_shuffled",
                      "_shuffle_seed", "minibatch_class",
                      "minibatch_size", "minibatch_offset")

    def __init__(self, workflow=None, name: str | None = None,
                 minibatch_size: int = 100,
                 shuffle_limit: int = np.iinfo(np.int64).max) -> None:
        super().__init__(workflow, name=name)
        self.max_minibatch_size = int(minibatch_size)
        #: epochs to keep shuffling (the order is frozen after them)
        self.shuffle_limit = shuffle_limit
        #: this step's batch (activation storage dtype), labels, sample
        #: indices and count of valid samples (a 0-d int64 device tensor:
        #: the last minibatch of a class is short)
        self.minibatch_data: torch.Tensor | None = None
        self.minibatch_labels: torch.Tensor | None = None
        self.minibatch_indices: torch.Tensor | None = None
        self.minibatch_valid: torch.Tensor | None = None
        self.class_lengths = [0, 0, 0]
        self.epoch_number = 0
        self.minibatch_class = TRAIN
        self.minibatch_size = 0          # true sample count this step
        self.minibatch_offset = 0
        self.epoch_ended = Bool(False)
        self._schedule: list[tuple[int, int, int]] = []  # (class, lo, hi)
        self._cursor = 0
        self._shuffled: np.ndarray | None = None
        self._shuffle_seed = 0
        #: ``(seed, epoch)`` → train permutation, the current epoch's and
        #: the look-ahead's; producer threads read it beside the control
        #: plane, hence the lock
        self._order_cache: dict[tuple[int, int], np.ndarray] = {}
        self._order_lock = threading.Lock()
        #: the device copies of the schedule need writing
        self._sched_dirty = True

    # ------------------------------------------------------------------
    @property
    def total_samples(self) -> int:
        return int(sum(self.class_lengths))

    @property
    def class_offsets(self) -> list[int]:
        """Global index where each class's samples start."""
        off, out = 0, []
        for length in self.class_lengths:
            out.append(off)
            off += length
        return out

    def class_index_range(self, cls: int) -> tuple[int, int]:
        lo = self.class_offsets[cls]
        return lo, lo + self.class_lengths[cls]

    @property
    def local_rows(self) -> int:
        """Rows of a minibatch this process gathers (all of them without
        a mesh)."""
        return self.max_minibatch_size // self.device.n_data_shards

    @property
    def forward_mode(self) -> str:
        """"train" on train minibatches, else "eval"."""
        return "train" if self.minibatch_class == TRAIN else "eval"

    # -- subclass API ---------------------------------------------------
    def load_data(self) -> None:
        raise NotImplementedError

    def create_minibatch_data(self) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def initialize(self, device=None, compute_dtype: torch.dtype
                   | None = None, **kwargs) -> None:
        """Attach to ``device`` (the workflow's when None), load the data
        and draw the shuffle seed.  The dtype of the stored batch
        follows ``compute_dtype``, else the device's precision mode."""
        super().initialize(device=device, **kwargs)
        self.compute_dtype = compute_dtype or self.device.compute_dtype
        self.load_data()
        if self.total_samples == 0:
            raise ValueError(f"{self.name}: load_data produced no samples")
        self.max_minibatch_size = min(self.max_minibatch_size,
                                      max(self.class_lengths))
        shards = self.device.n_data_shards
        if self.max_minibatch_size % shards:
            aligned = (self.max_minibatch_size // shards) * shards
            if aligned == 0:
                raise ValueError(
                    f"{self}: minibatch_size {self.max_minibatch_size} "
                    f"cannot be sharded over the mesh's {shards} data "
                    f"shards")
            self.warning(
                "minibatch_size %d not divisible by %d data shards — "
                "clamped to %d", self.max_minibatch_size, shards, aligned)
            self.max_minibatch_size = aligned
        self.create_minibatch_data()
        # one draw from the shared stream roots all epoch permutations
        # (the reference draws it here too, before any weight fill)
        self._shuffle_seed = int(prng.get().randint(0, 2 ** 63))
        self._order_cache.clear()
        self._build_schedule()
        self._shuffled = np.arange(self.total_samples, dtype=np.int32)
        self._cursor = 0
        self._shuffle_train()
        self.init_schedule()

    def init_schedule(self) -> None:
        """Hook: put the schedule on the device."""

    def _build_schedule(self) -> None:
        self._schedule = []
        for cls in (TEST, VALID, TRAIN):
            lo, hi = self.class_index_range(cls)
            for start in range(lo, hi, self.max_minibatch_size):
                self._schedule.append(
                    (cls, start, min(start + self.max_minibatch_size, hi)))

    # -- the counter-based epoch order -------------------------------------
    def train_order(self, epoch: int) -> np.ndarray:
        """Global indices of the TRAIN segment in the order epoch
        ``epoch`` visits them: a pure function of ``_shuffle_seed`` (any
        epoch, past or future).  After ``shuffle_limit`` epochs the
        order stays the last shuffled one."""
        lo, hi = self.class_index_range(TRAIN)
        n = hi - lo
        if n <= 0 or self.shuffle_limit <= 0:
            return np.arange(lo, hi, dtype=np.int32)
        eff = min(int(epoch), int(self.shuffle_limit) - 1)
        key = (self._shuffle_seed, eff)
        with self._order_lock:
            perm = self._order_cache.get(key)
            if perm is None:
                if len(self._order_cache) >= 4:  # current + look-ahead
                    self._order_cache.pop(next(iter(self._order_cache)))
                perm = self._order_cache[key] = epoch_permutation(
                    self._shuffle_seed, eff, n)
        return (lo + perm).astype(np.int32)

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The whole sample order of epoch ``epoch``: test and
        validation in their natural order, train shuffled."""
        order = np.arange(self.total_samples, dtype=np.int32)
        lo, hi = self.class_index_range(TRAIN)
        if hi > lo:
            order[lo:hi] = self.train_order(epoch)
        return order

    def schedule_entry(self, epoch: int, cursor: int
                       ) -> tuple[np.ndarray, int, int]:
        """``(padded indices, class, true count)`` of any schedule
        position, a future epoch's included: the short tail repeats its
        first sample, as the gather pads it."""
        cls, lo, hi = self._schedule[cursor]
        count = hi - lo
        order = self.epoch_order(epoch)
        idx = np.empty(self.max_minibatch_size, dtype=np.int32)
        idx[:count] = order[lo:hi]
        if count < self.max_minibatch_size:
            idx[count:] = idx[0]
        return idx, cls, count

    def _shuffle_train(self) -> None:
        """Put the TRAIN segment in this epoch's order (kept as it is
        past ``shuffle_limit``)."""
        if self.epoch_number >= self.shuffle_limit:
            return
        lo, hi = self.class_index_range(TRAIN)
        if hi > lo:
            self._shuffled[lo:hi] = self.train_order(self.epoch_number)
            self._sched_dirty = True  # the device copy is stale

    def state_dict(self, allow_collective: bool = False) -> dict:
        return {name: (np.array(getattr(self, name)) if name == "_shuffled"
                       else getattr(self, name))
                for name in self.SNAPSHOT_ATTRS}

    def load_state(self, state: dict) -> None:
        """Adopt the schedule state of a snapshot, the reference's
        included, so the run continues its exact sample order."""
        for name in self.SNAPSHOT_ATTRS:
            if name in state:
                value = state[name]
                setattr(self, name, np.array(value, dtype=np.int32)
                        if name == "_shuffled" else int(value))
        self._sched_dirty = True  # the device copies are stale

    # -- per-step control plane -------------------------------------------
    def host_run(self) -> None:
        """Pick the next minibatch of the schedule (the gather is the
        device work)."""
        if self._cursor >= len(self._schedule):
            # the previous step ended the epoch; begin the next one
            self._cursor = 0
            self.epoch_number += 1
            self._shuffle_train()
        cls, lo, hi = self._schedule[self._cursor]
        self._cursor += 1
        self.minibatch_class = cls
        self.minibatch_size = hi - lo
        self.minibatch_offset = lo
        self.epoch_ended.value = self._cursor >= len(self._schedule)
        self.sync_schedule()

    def sync_schedule(self) -> None:
        """Hook: write what the device's copy of the schedule needs after
        the pick (in place)."""


class StagedLoader(Loader):
    """A loader whose minibatch is read on the host (shard reads, image
    decode) and delivered to the device before each step.

    Its device tensors are allocated once and written in place by
    :meth:`deliver`, so a captured CUDA graph reads each step's batch at
    the address it captured: ``minibatch_raw`` (a :class:`Vector` of
    this process's rows in the dataset's dtype),
    ``minibatch_valid`` and ``minibatch_indices`` (views of one int64
    tensor: the count, then the rows' sample indices) and
    ``minibatch_labels`` (int32).  Its device work is the affine
    normalize of ``minibatch_raw`` into ``minibatch_data`` (the
    activation dtype), which runs in the training step's region; a
    uint8 batch is normalized through the 256-entry table, as the
    full-batch loader does, so both deliver the same activations.

    A host batch travels with a *meta* row, int64: ``[count, indices
    (local_rows), labels (local_rows)]``.
    """

    WRITES = ("minibatch_data",)

    def __init__(self, workflow=None,
                 normalization_scale: float | None = None,
                 normalization_bias: float = 0.0, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.normalization_scale = normalization_scale
        self.normalization_bias = normalization_bias
        self.minibatch_raw = Vector(name=f"{self.name}.minibatch_raw")
        self._meta: torch.Tensor | None = None
        self._table: torch.Tensor | None = None

    # -- subclass API -------------------------------------------------------
    @property
    def sample_shape(self) -> tuple[int, ...]:
        raise NotImplementedError

    @property
    def raw_dtype(self) -> np.dtype:
        """The dtype the batch travels in (the dataset's)."""
        raise NotImplementedError

    @property
    def has_labels(self) -> bool:
        return True

    # -- the fixed device tensors ---------------------------------------------
    @property
    def meta_len(self) -> int:
        return 1 + 2 * self.local_rows

    def create_minibatch_data(self) -> None:
        rows = self.local_rows
        self.minibatch_raw.reset(np.zeros((rows,) + tuple(self.sample_shape),
                                          dtype=self.raw_dtype))
        self.init_vectors(self.minibatch_raw)
        dev = self.torch_device
        self._meta = torch.zeros(1 + rows, dtype=torch.int64, device=dev)
        self.minibatch_valid = self._meta[0]
        self.minibatch_indices = self._meta[1:]
        self.minibatch_labels = (torch.zeros(rows, dtype=torch.int32,
                                             device=dev)
                                 if self.has_labels else None)
        if self.normalization_scale is not None \
                and np.dtype(self.raw_dtype) == np.uint8 \
                and not self.device.is_host_only:
            self._table = normalization_table(
                self.normalization_scale, self.normalization_bias,
                self.act_store_dtype, dev)

    def fill_meta(self, meta: np.ndarray, count: int, idx: np.ndarray,
                  labels: np.ndarray | None) -> None:
        """Write a host meta row (``count``, this process's ``idx`` and
        their ``labels``)."""
        rows = self.local_rows
        meta[0] = count
        meta[1:1 + rows] = idx
        if labels is not None:
            meta[1 + rows:] = labels

    def deliver(self, raw: torch.Tensor, meta: torch.Tensor) -> None:
        """This step's batch: ``raw`` and ``meta`` (on the device, or in
        page-locked host memory) copied into the fixed tensors, on the
        current stream and in place."""
        rows = self.local_rows
        self.minibatch_raw.accept_device(raw)
        self._meta.copy_(meta[:1 + rows], non_blocking=True)
        if self.minibatch_labels is not None:
            self.minibatch_labels.copy_(meta[1 + rows:], non_blocking=True)

    # -- the normalize (the unit's device work) ---------------------------------
    def device_run(self) -> None:
        self.minibatch_data = normalize(
            self.minibatch_raw.devmem, self._table,
            self.normalization_scale, self.normalization_bias,
            self.act_store_dtype)

    def numpy_run(self) -> None:
        batch = np.asarray(self.minibatch_raw.mem).astype(np.float32)
        if self.normalization_scale is not None:
            batch = batch * np.float32(self.normalization_scale) \
                + np.float32(self.normalization_bias)
        self.minibatch_data = batch
