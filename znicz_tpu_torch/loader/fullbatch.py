"""Full-batch loaders: the whole dataset resident on the device, each
minibatch an on-device gather (port of ``znicz_tpu/loader/fullbatch.py``).

The dataset stays in its original dtype on the device (a bf16 dataset
costs half of f32, a uint8 image set a quarter); the gathered batch is
stored at the activation dtype, after the optional affine
normalization ``x·normalization_scale + normalization_bias``, both
constants f32 as in the reference, whose compiled gather fuses the two
into one multiply-add.  A uint8 dataset takes that rounding exactly: the
256 values it can hold are normalized once on the host (in f64, where
the product and the sum are exact, then rounded once to f32 and to the
activation dtype), and the gather looks each pixel up in that table, so
the same pixel gives the same activation as in the reference, with no
f32 pass over the batch between the uint8 gather and the stored
activations (only the int32 index the lookup takes).  Other dtypes are
normalized in f32 (two roundings: at most one f32 ulp from the
reference's fused result).

The schedule lives on the device (the reference's ``device_schedule``):
the epoch order, each minibatch's start and count, and a cursor, from
which the gather indexes.  A step moves no index from the host, and a
captured CUDA graph, which reads no host value, finds each step's
minibatch by itself.  The host writes the order into its tensor once a
shuffle and the cursor once a resume, in place (:class:`Vector`'s
rule), so the graph sees them.

On the numpy oracle the gather is the reference's ``numpy_run``: the
host's pick indexes the dataset, normalized in f32 (a multiply, then an
add) as the reference's numpy path does.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.loader.base import (TEST, TRAIN, VALID, Loader,
                                         normalization_table, normalize)
from znicz_tpu_torch.memory import Vector


def _as_tensor(a) -> torch.Tensor:
    """A dataset array as a CPU tensor (numpy or torch input)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


class FullBatchLoader(Loader):
    """Loader whose subclass provides the entire dataset as tensors.

    Subclasses implement :meth:`load_data` and set ``original_data`` /
    ``original_labels`` plus ``class_lengths``.  Samples are ordered
    test, validation, train along axis 0.
    """

    device_schedule = True

    def __init__(self, workflow=None,
                 normalization_scale: float | None = None,
                 normalization_bias: float = 0.0, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.normalization_scale = normalization_scale
        self.normalization_bias = normalization_bias
        self.original_data: torch.Tensor | None = None
        self.original_labels: torch.Tensor | None = None
        #: a uint8 dataset's normalized values, by pixel value
        self._table: torch.Tensor | None = None
        #: the schedule on the device: the epoch order, each entry's start
        #: and count, the cursor at the entry the last step gathered
        self.sched_perm = Vector(name=f"{self.name}.sched_perm")
        self.sched_starts = Vector(name=f"{self.name}.sched_starts")
        self.sched_counts = Vector(name=f"{self.name}.sched_counts")
        self.sched_cursor = Vector(name=f"{self.name}.sched_cursor")

    @property
    def _order(self) -> torch.Tensor:
        """The epoch order on the device."""
        return self.sched_perm.devmem

    @property
    def sample_shape(self) -> tuple:
        return tuple(self.original_data.shape[1:])

    WRITES = ("minibatch_data",)

    def create_minibatch_data(self) -> None:
        if self.device.is_host_only \
                and self.original_data.dtype == torch.bfloat16:
            self.original_data = self.original_data.float()  # numpy: f32
        self.original_data = self.original_data.to(self.torch_device)
        if self.original_labels is not None:
            self.original_labels = self.original_labels.to(
                self.torch_device)
        if self.normalization_scale is not None \
                and self.original_data.dtype == torch.uint8:
            self._table = normalization_table(
                self.normalization_scale, self.normalization_bias,
                self.act_store_dtype, self.torch_device)

    # -- the schedule on the device ----------------------------------------
    def init_schedule(self) -> None:
        self.sched_perm.reset(self._shuffled.astype(np.int64))
        self.sched_starts.reset(np.asarray(
            [lo for _, lo, _ in self._schedule], dtype=np.int64))
        self.sched_counts.reset(np.asarray(
            [hi - lo for _, lo, hi in self._schedule], dtype=np.int64))
        self.sched_cursor.reset(np.zeros((), dtype=np.int64))
        self.init_vectors(self.sched_perm, self.sched_starts,
                          self.sched_counts, self.sched_cursor)
        self._sched_dirty = False  # just written

    def sync_schedule(self) -> None:
        if not self._sched_dirty:
            return
        # once a shuffle or a resume: the order, and the cursor at the
        # entry just picked; both written into their tensors in place
        self.sched_perm.map_invalidate()
        self.sched_perm.mem[...] = self._shuffled
        self.sched_cursor.map_invalidate()
        self.sched_cursor.mem[...] = self._cursor - 1
        self.unmap_vectors(self.sched_perm, self.sched_cursor)
        self._sched_dirty = False

    # -- the gather (the unit's device work) ------------------------------
    def device_run(self) -> None:
        cursor = self.sched_cursor.devmem.view(1)
        start = self.sched_starts.devmem.index_select(0, cursor)
        count = self.sched_counts.devmem.index_select(0, cursor)
        rows = self.local_rows
        # this process's block of the minibatch's rows (all of them
        # without a mesh)
        offs = torch.arange(rows, device=start.device) \
            + self.device.data_rank * rows
        # the short tail repeats its first sample (masked by count)
        pos = start + torch.where(offs < count, offs, 0)
        idx = self.sched_perm.devmem.index_select(0, pos)
        self.sched_cursor.devmem = (cursor[0] + 1) % len(self._schedule)
        self.minibatch_indices = idx
        self.minibatch_valid = count[0]
        self.minibatch_data = normalize(
            self.original_data.index_select(0, idx), self._table,
            self.normalization_scale, self.normalization_bias,
            self.act_store_dtype)
        if self.original_labels is not None:
            self.minibatch_labels = self.original_labels.index_select(0,
                                                                      idx)

    def numpy_run(self) -> None:
        _, lo, hi = self._schedule[self._cursor - 1]
        count = hi - lo
        offs = np.arange(self.max_minibatch_size)
        # the short tail repeats its first sample (masked by count)
        idx = self._shuffled[lo + np.where(offs < count, offs, 0)]
        self.minibatch_indices = idx
        self.minibatch_valid = count
        batch = self.original_data.numpy()[idx].astype(np.float32)
        if self.normalization_scale is not None:
            batch = batch * np.float32(self.normalization_scale) \
                + np.float32(self.normalization_bias)
        self.minibatch_data = batch
        if self.original_labels is not None:
            self.minibatch_labels = self.original_labels.numpy()[idx]


class ArrayLoader(FullBatchLoader):
    """FullBatchLoader fed directly with arrays per class (numpy arrays
    or CPU tensors; a bf16 tensor keeps a bf16 dataset)."""

    def __init__(self, workflow=None, train_data=None, train_labels=None,
                 valid_data=None, valid_labels=None, test_data=None,
                 test_labels=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if train_data is None:
            raise ValueError("train_data is required")
        self._arrays = ((test_data, test_labels), (valid_data, valid_labels),
                        (train_data, train_labels))

    def load_data(self) -> None:
        datas, labels = [], []
        lengths = [0, 0, 0]
        for cls, (d, l) in zip((TEST, VALID, TRAIN), self._arrays):
            if d is None:
                if l is not None:
                    raise ValueError(f"{self.name}: labels without data "
                                     f"for class {cls}")
                continue
            lengths[cls] = len(d)
            datas.append(_as_tensor(d))
            labels.append(None if l is None
                          else _as_tensor(np.asarray(l, dtype=np.int32)))
        if any(l is not None for l in labels):
            if any(l is None for l in labels):
                # labels index by global sample position: partial labels
                # would misalign the gather
                raise ValueError(
                    f"{self.name}: labels given for some classes but not "
                    f"others — provide labels for every supplied split")
            self.original_labels = torch.cat(labels)
        self.class_lengths = lengths
        self.original_data = torch.cat(datas)
