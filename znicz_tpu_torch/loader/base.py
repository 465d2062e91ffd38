"""Loader base: the minibatch schedule (port of
``znicz_tpu/loader/base.py``).

- three sample classes ``TEST=0 / VALID=1 / TRAIN=2`` with
  ``class_lengths``; one epoch walks every non-empty class in order
  (test, validation, train), so the decision unit can count errors per
  class;
- the train indices are reshuffled every epoch, counter-based: epoch
  *e*'s order is :func:`epoch_permutation` of ``(shuffle_seed, e)``
  (numpy's Philox, copied from the reference, so the same seed gives
  the same order bit for bit in both packages);
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
training step's region (:mod:`znicz_tpu_torch.loader.fullbatch`).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit
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
                 minibatch_size: int = 100) -> None:
        super().__init__(workflow, name=name)
        self.max_minibatch_size = int(minibatch_size)
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

    def _shuffle_train(self) -> None:
        """Put the TRAIN segment in this epoch's order."""
        lo, hi = self.class_index_range(TRAIN)
        if hi > lo:
            self._shuffled[lo:hi] = lo + epoch_permutation(
                self._shuffle_seed, self.epoch_number, hi - lo)
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
