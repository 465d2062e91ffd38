"""The streaming data plane: a sharded on-disk dataset read ahead of the
step by background threads (port of ``znicz_tpu/loader/streaming.py``).

:class:`StreamingLoader` reads file shards (:func:`write_shards`'s
format, byte for byte the reference's: ``manifest.json`` and ``.npy``
shards, so either package reads the other's) through a pipeline:

1. **readers** gather each minibatch's rows from the memory-mapped
   shards into a slot of a bounded :class:`~znicz_tpu_torch.memory.
   StagingRing` (page-locked on the card, allocated once), with its
   meta row (the count, the sample indices, the labels) beside it;
2. **the uploader** thread copies the slot into one of
   ``prefetch_depth`` device staging tensors on a side stream, records
   an event, waits for it, and only then releases the slot (a slot
   freed before its asynchronous copy has read it would hand the next
   batch corrupt data, with no error);
3. **the consumer** (:meth:`StreamingLoader.host_run`) makes the compute
   stream wait for that event, copies the staged batch into the fixed
   ``minibatch_raw`` tensor that the training step's CUDA graph reads
   (one device-to-device copy, in place: a rebinding would be refused
   by the next replay), and records the event after which the uploader
   may reuse the staging tensor.

The reference uploads with ``device_put`` and delivers by swapping the
pointer.  The bounded queues are the back-pressure; the host holds
``ring_slots × batch bytes`` however large the dataset.  The uploader's
CUDA calls hold :data:`~znicz_tpu_torch.accelerated_units.CAPTURE_LOCK`,
so a region capturing its graph (in the global mode) sees no call from
another thread.  On the CPU the same pipeline runs with plain buffers
and synchronous copies.

The order is counter-based (:meth:`~znicz_tpu_torch.loader.base.Loader.
schedule_entry`): the producer reads across epoch boundaries, a resumed
run re-derives its position from the snapshot, and the streamed order
is the full-batch loader's, bit for bit, for one seed.  Each of
``process_count`` processes reads only its block of every minibatch's
rows (its ``local_rows``); the blocks partition the epoch.

Faults (:mod:`~znicz_tpu_torch.resilience.faults`): ``loader.
reader_death`` kills the producer (the consumer gets a poison pill and
:class:`PipelineDead`, and the loader rebuilds the pipeline at the same
position, up to ``engine.reader_restarts`` times: the batches are the
clean run's, bit for bit); ``loader.corrupt_shard`` and
``loader.short_read`` fail a shard read, which is retried
``engine.read_retries`` times with back-off and then quarantined (its
rows deliver zeros, counted).  A shard's CRC is checked on first open
(``engine.shard_crc``, default on).

Telemetry: ``znicz_input_wait_seconds`` (the consumer blocked),
``znicz_input_stage_seconds`` (a producer's read), ``znicz_prefetch_
depth``, ``znicz_loader_prefetch_total{hit|miss|epoch_cross}``,
``znicz_prefetch_ready_batches``, the uploads in
``znicz_device_transfer_bytes_total{h2d}`` and the span
``input_wait:<loader>``.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import CAPTURE_LOCK
from znicz_tpu_torch.loader.base import StagedLoader
from znicz_tpu_torch.memory import StagingRing
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.utils.config import root

MANIFEST_NAME = "manifest.json"


class ShardReadError(RuntimeError):
    """A shard read failed (CRC mismatch, IO error, injected fault); it
    carries the shard so that the retry path can quarantine it."""

    def __init__(self, shard: int | None, msg: str) -> None:
        super().__init__(msg)
        self.shard = shard


class PipelineDead(RuntimeError):
    """A pipeline thread died.  Raised in the consumer (a poison pill
    through the queue: the consumer never hangs on a dead producer);
    the loader absorbs ``engine.reader_restarts`` of them (default 2)
    by rebuilding the pipeline."""


def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


# ----------------------------------------------------------------------
# the on-disk shard format
# ----------------------------------------------------------------------
def write_shards(out_dir: str,
                 train_data: np.ndarray,
                 train_labels: np.ndarray | None = None,
                 valid_data: np.ndarray | None = None,
                 valid_labels: np.ndarray | None = None,
                 test_data: np.ndarray | None = None,
                 test_labels: np.ndarray | None = None,
                 rows_per_shard: int = 4096) -> str:
    """Write arrays as a sharded streaming dataset (what
    :class:`ShardReader` reads).  Rows go in global-index order (test,
    validation, train), the full-batch loaders' convention, so index
    *i* is the same sample to every loader."""
    os.makedirs(out_dir, exist_ok=True)
    datas: list[np.ndarray] = []
    labels: list[np.ndarray | None] = []
    lengths = [0, 0, 0]
    for cls, (d, lab) in enumerate(((test_data, test_labels),
                                    (valid_data, valid_labels),
                                    (train_data, train_labels))):
        if d is None:
            if lab is not None:
                raise ValueError(f"labels without data for class {cls}")
            continue
        lengths[cls] = len(d)
        datas.append(np.asarray(d))
        labels.append(None if lab is None
                      else np.asarray(lab, dtype=np.int32))
    if not datas:
        raise ValueError("write_shards: no data given")
    if any(lab is not None for lab in labels) \
            and any(lab is None for lab in labels):
        raise ValueError("labels given for some classes but not others")
    data = np.concatenate(datas, axis=0)
    labs = (np.concatenate([lab for lab in labels if lab is not None])
            if labels[0] is not None else None)
    shards = []
    for i, lo in enumerate(range(0, len(data), int(rows_per_shard))):
        chunk = np.ascontiguousarray(data[lo:lo + rows_per_shard])
        fn = f"data-{i:05d}.npy"
        np.save(os.path.join(out_dir, fn), chunk)
        entry: dict = {"data": fn, "rows": int(len(chunk)),
                       "crc32": _file_crc32(os.path.join(out_dir, fn))}
        if labs is not None:
            lfn = f"labels-{i:05d}.npy"
            np.save(os.path.join(out_dir, lfn),
                    labs[lo:lo + rows_per_shard])
            entry["labels"] = lfn
            entry["labels_crc32"] = _file_crc32(
                os.path.join(out_dir, lfn))
        shards.append(entry)
    manifest = {"version": 1,
                "class_lengths": [int(n) for n in lengths],
                "sample_shape": [int(s) for s in data.shape[1:]],
                "dtype": str(data.dtype),
                "shards": shards}
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return out_dir


class ShardReader:
    """Random access over a shard directory.

    Shards open as read-only numpy memory maps on first touch (their
    CRC checked first); :meth:`gather` indexes them into a caller's
    buffer, so the disk reads are page faults in whichever reader thread
    called.  The labels (small) load at once."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        #: the label of the rows-quarantined counter (the owning loader
        #: sets its name)
        self.obs_label = os.path.basename(
            os.path.normpath(directory)) or directory
        path = os.path.join(directory, MANIFEST_NAME)
        with open(path) as fh:
            self.manifest = json.load(fh)
        self.class_lengths = [int(n)
                              for n in self.manifest["class_lengths"]]
        self.sample_shape = tuple(self.manifest["sample_shape"])
        self.dtype = np.dtype(self.manifest["dtype"])
        self._shards = self.manifest["shards"]
        rows = np.asarray([s["rows"] for s in self._shards],
                          dtype=np.int64)
        self._offsets = np.concatenate(([0], np.cumsum(rows)))
        self.n_samples = int(self._offsets[-1])
        if self.n_samples != sum(self.class_lengths):
            raise ValueError(
                f"{path}: shard rows {self.n_samples} != "
                f"class_lengths sum {sum(self.class_lengths)}")
        self._maps: list[np.ndarray | None] = [None] * len(self._shards)
        self._lock = threading.Lock()
        #: shards that ran out of read retries: their rows deliver zeros
        #: for the rest of the run
        self._quarantined: set[int] = set()
        self.has_labels = all("labels" in s for s in self._shards)
        self._labels: np.ndarray | None = None
        if self.has_labels:
            parts = []
            for i, s in enumerate(self._shards):
                lpath = os.path.join(directory, s["labels"])
                want = s.get("labels_crc32")
                if want is not None and self.verify_crc \
                        and _file_crc32(lpath) != int(want):
                    raise ShardReadError(
                        i, f"{lpath}: labels CRC mismatch — dataset "
                           f"corrupt on disk")
                parts.append(np.load(lpath))
            self._labels = np.concatenate(parts).astype(np.int32)

    @property
    def verify_crc(self) -> bool:
        """``root.common.engine.shard_crc`` (default on): check each
        shard's CRC from the manifest on first open."""
        return bool(root.common.engine.get("shard_crc", True))

    @property
    def quarantined(self) -> frozenset:
        return frozenset(self._quarantined)

    def quarantine(self, shard: int) -> None:
        """Mark a shard bad for good: drop its map, deliver zeros."""
        with self._lock:
            self._quarantined.add(int(shard))
            self._maps[int(shard)] = None

    @property
    def nbytes(self) -> int:
        """The dataset's size (what a resident loader would hold)."""
        return self.n_samples * self.dtype.itemsize \
            * int(np.prod(self.sample_shape, dtype=np.int64))

    def _mmap(self, shard: int) -> np.ndarray:
        arr = self._maps[shard]
        if arr is None:
            with self._lock:
                arr = self._maps[shard]
                if arr is None:
                    path = os.path.join(
                        self.directory, self._shards[shard]["data"])
                    want = self._shards[shard].get("crc32")
                    if want is not None and self.verify_crc \
                            and _file_crc32(path) != int(want):
                        raise ShardReadError(
                            shard, f"{path}: CRC mismatch (manifest "
                                   f"{int(want)}) — shard corrupt on "
                                   f"disk")
                    arr = np.load(path, mmap_mode="r")
                    self._maps[shard] = arr
        return arr

    def gather(self, idx: np.ndarray, out: np.ndarray) -> None:
        """``out[k] = dataset[idx[k]]`` across shard boundaries.  A
        quarantined shard gives zero rows (counted); the fault sites
        ``loader.corrupt_shard`` and ``loader.short_read`` raise here
        as a real CRC or IO failure would."""
        idx = np.asarray(idx, dtype=np.int64)
        shard_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for s in np.unique(shard_of):
            s = int(s)
            mask = shard_of == s
            if s in self._quarantined:
                out[mask] = 0
                _metrics.loader_rows_quarantined(self.obs_label).inc(
                    int(mask.sum()))
                continue
            if _faults.fire("loader.corrupt_shard", shard=s) is not None:
                raise ShardReadError(s, f"injected corrupt shard {s}")
            if _faults.fire("loader.short_read", shard=s) is not None:
                raise ShardReadError(s, f"injected short read on "
                                        f"shard {s}")
            rows = idx[mask] - self._offsets[s]
            out[mask] = self._mmap(s)[rows]

    def labels(self, idx: np.ndarray) -> np.ndarray:
        if self._labels is None:
            raise ValueError(f"{self.directory}: the shards have no labels")
        return self._labels[np.asarray(idx, dtype=np.int64)]


# ----------------------------------------------------------------------
# the pipeline
# ----------------------------------------------------------------------
@dataclass
class _Item:
    """One minibatch on its way: read → upload → deliver."""
    key: tuple[int, int]                 # its (epoch, cursor)
    slot: int | None = None              # its ring slot, until uploaded
    stage: int | None = None             # its staging tensor, once uploaded
    crossed_epoch: bool = field(default=False)
    #: poison pill: a pipeline thread died; wakes the consumer at once
    pill: bool = field(default=False)


class _StreamPipeline:
    """The producer (reader pool → ring slot) and uploader (slot →
    staging tensor) threads for one run of schedule positions from
    ``(epoch, cursor)``.  A resume or a thread's death tears it down and
    builds a new one at the position wanted."""

    def __init__(self, loader: "StreamingLoader",
                 epoch: int, cursor: int) -> None:
        self.loader = loader
        self.start_key = (epoch, cursor)
        self.stop_flag = threading.Event()
        self.error: BaseException | None = None
        dev = loader.torch_device
        self.cuda = dev.type == "cuda"
        shape = (loader.local_batch,) + tuple(loader.sample_shape)
        self.ring = StagingRing(loader.ring_slots, shape,
                                loader.dataset_dtype, pin=self.cuda)
        #: each slot's meta row, at the slot's index (never acquired)
        self.meta_ring = StagingRing(loader.ring_slots, (loader.meta_len,),
                                     np.int64, pin=self.cuda)
        # the staging tensors (on the device; host tensors elsewhere),
        # allocated here, on the caller's (compute) stream
        depth = loader.prefetch_depth
        self.stage_raw = [torch.empty(shape, dtype=self.ring.tensor(0).dtype,
                                      device=dev) for _ in range(depth)]
        self.stage_meta = [torch.empty(loader.meta_len, dtype=torch.int64,
                                       device=dev) for _ in range(depth)]
        if self.cuda:
            self.side = torch.cuda.Stream(dev)
            #: recorded by the uploader after a copy into a staging tensor
            self.ready = [torch.cuda.Event() for _ in range(depth)]
            #: recorded by the consumer after its copy out of one
            self.freed = [torch.cuda.Event() for _ in range(depth)]
        self._free_stage: "queue.Queue[int]" = queue.Queue()
        for k in range(depth):
            self._free_stage.put(k)
        self.read_q: "queue.Queue[_Item]" = queue.Queue(
            maxsize=loader.ring_slots)
        self.dev_q: "queue.Queue[_Item]" = queue.Queue(maxsize=depth)
        self._pool = (ThreadPoolExecutor(
            loader.n_reader_threads,
            thread_name_prefix=f"{loader.name}.reader")
            if loader.n_reader_threads > 1 else None)
        self._producer = threading.Thread(
            target=self._thread_body, args=(self._produce, epoch, cursor),
            name=f"{loader.name}.producer", daemon=True)
        self._uploader = threading.Thread(
            target=self._thread_body, args=(self._upload,),
            name=f"{loader.name}.uploader", daemon=True)
        self._producer.start()
        self._uploader.start()

    @property
    def staging_nbytes(self) -> int:
        """Bytes of the staging tensors."""
        return sum(t.numel() * t.element_size()
                   for t in self.stage_raw + self.stage_meta)

    # -- death propagation -----------------------------------------------
    def _thread_body(self, fn, *args) -> None:
        """Run a stage; on any death record the cause and push a poison
        pill through the device queue, so that the consumer raises
        :class:`PipelineDead` at once."""
        try:
            fn(*args)
        except BaseException as exc:  # noqa: BLE001 — must not die silent
            if not self.stop_flag.is_set():
                if self.error is None:
                    self.error = exc
                try:
                    self.dev_q.put_nowait(_Item((-1, -1), pill=True))
                except queue.Full:
                    pass  # take()'s poll loop sees self.error

    # -- stage 1: the shard gather into a ring slot ----------------------
    def _produce(self, epoch: int, cursor: int) -> None:
        loader = self.loader
        n_sched = len(loader._schedule)
        start_epoch = epoch
        while not self.stop_flag.is_set():
            slot = self.ring.acquire(timeout=0.1)
            if slot is None:
                continue
            try:
                if _faults.fire("loader.reader_death") is not None:
                    raise _faults.FaultInjected(
                        f"{loader.name}: injected reader-thread death")
                t0 = time.perf_counter()
                idx, _cls, count = loader.schedule_entry(epoch, cursor)
                local = loader._local_slice(idx)
                self._gather_retry(local, self.ring.buffer(slot))
                labels = (loader._reader.labels(local)
                          if loader.has_labels else None)
                loader.fill_meta(self.meta_ring.buffer(slot), count, local,
                                 labels)
                if _metrics.enabled():
                    _metrics.input_stage_seconds(loader.name).observe(
                        time.perf_counter() - t0)
                item = _Item((epoch, cursor), slot=slot,
                             crossed_epoch=epoch > start_epoch
                             and cursor == 0)
            except BaseException:
                self.ring.release(slot)
                raise
            if not self._put(self.read_q, item):
                self.ring.release(slot)
                return
            cursor += 1
            if cursor >= n_sched:
                cursor, epoch = 0, epoch + 1

    def _gather_retry(self, local_idx: np.ndarray,
                      buf: np.ndarray) -> None:
        """The shard gather with retries and quarantine: a failed read
        is retried ``engine.read_retries`` times with exponential
        back-off; a shard that still fails is quarantined (its rows
        deliver zeros) and the gather goes on."""
        loader = self.loader
        reader = loader._reader
        retries = int(root.common.engine.get("read_retries", 2))
        backoff = float(root.common.engine.get("read_backoff_s", 0.05))
        attempts = 0
        while True:
            try:
                self._gather(local_idx, buf)
                if attempts:
                    _metrics.recoveries("shard_retry").inc()
                return
            except ShardReadError as exc:
                if self.stop_flag.is_set():
                    raise
                attempts += 1
                _metrics.loader_read_retries(loader.name).inc()
                if attempts <= retries:
                    loader.warning(
                        "shard read failed (%s) — retry %d/%d",
                        exc, attempts, retries)
                    time.sleep(backoff * (2 ** (attempts - 1)))
                    continue
                shard = exc.shard
                if shard is None or shard in reader.quarantined:
                    raise  # not one shard's fault: a real death
                reader.quarantine(shard)
                _metrics.loader_shards_quarantined(loader.name).inc()
                _metrics.recoveries("shard_quarantine").inc()
                loader.warning(
                    "shard %d quarantined after %d failed reads (%s) "
                    "— its rows deliver zeros for the rest of the run",
                    shard, attempts, exc)
                attempts = 0  # a fresh budget for the other shards

    def _gather(self, local_idx: np.ndarray, buf: np.ndarray) -> None:
        reader = self.loader._reader
        n = len(local_idx)
        pool = self._pool
        t = self.loader.n_reader_threads
        if pool is None or n < 2 * t:
            reader.gather(local_idx, buf)
            return
        step = -(-n // t)  # t contiguous row ranges
        futs = [pool.submit(reader.gather, local_idx[lo:lo + step],
                            buf[lo:lo + step])
                for lo in range(0, n, step)]
        for f in futs:
            f.result()

    # -- stage 2: the copy to a staging tensor -----------------------------
    def _upload(self) -> None:
        with (torch.cuda.device(self.loader.torch_device) if self.cuda
              else contextlib.nullcontext()):
            self._upload_loop()

    def _upload_loop(self) -> None:
        nbytes = (self.ring.buffer(0).nbytes
                  + self.meta_ring.buffer(0).nbytes)
        while not self.stop_flag.is_set():
            try:
                item = self.read_q.get(timeout=0.1)
            except queue.Empty:
                continue
            k = self._get(self._free_stage)
            if k is None:
                self.ring.release(item.slot)
                return
            try:
                self._copy(item.slot, k)
            except BaseException:
                self.ring.release(item.slot)
                self._free_stage.put(k)
                raise
            if _metrics.enabled():
                _metrics.transfer_bytes("h2d").inc(nbytes)
            self.ring.release(item.slot)
            item.slot, item.stage = None, k
            if not self._put(self.dev_q, item):
                self._free_stage.put(k)
                return

    def _copy(self, slot: int, k: int) -> None:
        """Ring slot → staging tensor ``k``; returns once the copy has
        read the slot."""
        raw, meta = self.ring.tensor(slot), self.meta_ring.tensor(slot)
        if not self.cuda:
            self.stage_raw[k].copy_(raw)
            self.stage_meta[k].copy_(meta)
            return
        # no CUDA call from this thread while the region captures
        with CAPTURE_LOCK, torch.cuda.stream(self.side):
            # the consumer's copy out of tensor k (an event never
            # recorded is no wait)
            self.side.wait_event(self.freed[k])
            self.stage_raw[k].copy_(raw, non_blocking=True)
            self.stage_meta[k].copy_(meta, non_blocking=True)
            self.ready[k].record(self.side)
            # the slot is reused once released: the copy must be done
            self.ready[k].synchronize()

    def _get(self, q: "queue.Queue[int]") -> int | None:
        while not self.stop_flag.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def _put(self, q: "queue.Queue[_Item]", item: _Item) -> bool:
        while not self.stop_flag.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- the consumer's side ------------------------------------------------
    def take(self, timeout: float = 300.0) -> _Item:
        deadline = time.monotonic() + timeout
        while True:
            try:
                item = self.dev_q.get(timeout=0.1)
            except queue.Empty:
                if self.error is not None:
                    raise PipelineDead(
                        f"{self.loader}: streaming producer died"
                    ) from self.error
                if time.monotonic() > deadline:
                    raise PipelineDead(
                        f"{self.loader}: streaming pipeline produced "
                        f"nothing for {timeout:.0f}s — reader thread "
                        f"dead?") from None
                continue
            if item.pill:
                raise PipelineDead(
                    f"{self.loader}: streaming pipeline thread died"
                ) from self.error
            return item

    def take_nowait(self) -> _Item | None:
        try:
            item = self.dev_q.get_nowait()
        except queue.Empty:
            return None
        if item.pill:
            raise PipelineDead(
                f"{self.loader}: streaming pipeline thread died"
            ) from self.error
        return item

    def deliver(self, item: _Item) -> None:
        """``item``'s staged batch into the loader's fixed tensors (on
        the current stream), and its staging tensor back to the
        uploader once that copy has run."""
        k = item.stage
        if self.cuda:
            stream = torch.cuda.current_stream(self.loader.torch_device)
            stream.wait_event(self.ready[k])
            self.loader.deliver(self.stage_raw[k], self.stage_meta[k])
            self.freed[k].record(stream)
        else:
            self.loader.deliver(self.stage_raw[k], self.stage_meta[k])
        item.stage = None
        self._free_stage.put(k)

    def release(self, item: _Item) -> None:
        """Give back what an undelivered item holds."""
        if item.slot is not None:
            self.ring.release(item.slot)
        if item.stage is not None:
            self._free_stage.put(item.stage)

    @property
    def ready_batches(self) -> int:
        """Uploaded batches waiting for the consumer."""
        return self.dev_q.qsize()

    def stop(self) -> None:
        self.stop_flag.set()
        self._producer.join(timeout=5.0)
        self._uploader.join(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)


# ----------------------------------------------------------------------
# the loader
# ----------------------------------------------------------------------
class StreamingLoader(StagedLoader):
    """A minibatch loader over a sharded on-disk dataset, read ahead by
    a background pipeline (the module's docstring has the design).

    Parameters
    ----------
    shard_dir:
        a directory :func:`write_shards` wrote.
    prefetch_depth:
        batches uploaded ahead of the step (≥ 1): the device staging
        tensors.
    ring_slots:
        host staging slots (default ``prefetch_depth + 2``: one being
        read, one being uploaded, and slack).
    n_reader_threads:
        threads that gather one minibatch's rows.
    process_index / process_count:
        this process's block of every minibatch's rows (default: the
        rank and world size of the process group, else 0 and 1).  The
        process reads rows ``[p·B/P, (p+1)·B/P)`` of each global
        minibatch; together the blocks partition the epoch.
    normalization_scale / normalization_bias:
        the affine ``x·scale + bias`` in the region (the batch travels
        in the dataset's dtype).
    """

    def __init__(self, workflow, shard_dir: str,
                 name: str | None = None,
                 normalization_scale: float | None = None,
                 normalization_bias: float = 0.0,
                 prefetch_depth: int = 2,
                 ring_slots: int | None = None,
                 n_reader_threads: int = 2,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name,
                         normalization_scale=normalization_scale,
                         normalization_bias=normalization_bias, **kwargs)
        self.shard_dir = shard_dir
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.ring_slots = int(ring_slots) if ring_slots \
            else self.prefetch_depth + 2
        self.n_reader_threads = max(1, int(n_reader_threads))
        if (process_index is None) != (process_count is None):
            raise ValueError(f"{self}: give both process_index and "
                             f"process_count or neither")
        self._pidx_arg = process_index
        self._pcount_arg = process_count
        self._pidx, self._pcount = 0, 1
        self._reader: ShardReader | None = None
        self._pipe: _StreamPipeline | None = None
        # the overlap counters (the metrics registry has them too)
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.input_wait_s = 0.0
        self.epoch_cross_prefetches = 0
        #: pipeline rebuilds after a thread's death, this run
        self.pipeline_restarts = 0

    # -- the dataset ------------------------------------------------------
    def load_data(self) -> None:
        self._reader = ShardReader(self.shard_dir)
        self._reader.obs_label = self.name
        self.class_lengths = list(self._reader.class_lengths)

    @property
    def has_labels(self) -> bool:
        return self._reader.has_labels

    @property
    def sample_shape(self) -> tuple[int, ...]:
        return self._reader.sample_shape

    @property
    def dataset_dtype(self) -> np.dtype:
        return self._reader.dtype

    raw_dtype = dataset_dtype

    @property
    def dataset_nbytes(self) -> int:
        return self._reader.nbytes

    @property
    def local_batch(self) -> int:
        """Rows of each minibatch this process reads."""
        return self.max_minibatch_size // self._pcount

    @property
    def local_rows(self) -> int:
        return self.local_batch

    def _local_slice(self, idx: np.ndarray) -> np.ndarray:
        lb = self.local_batch
        return idx[self._pidx * lb:(self._pidx + 1) * lb]

    def local_indices(self, epoch: int, cursor: int) -> np.ndarray:
        """The sample indices this process reads at schedule position
        ``(epoch, cursor)``."""
        idx, _cls, _count = self.schedule_entry(epoch, cursor)
        return self._local_slice(idx)

    def initialize(self, device=None, **kwargs) -> None:
        if self._pidx_arg is not None:
            self._pidx = int(self._pidx_arg)
            self._pcount = int(self._pcount_arg)
        else:
            from znicz_tpu_torch.parallel.distributed import process_info
            self._pidx, self._pcount = process_info()
        super().initialize(device=device, **kwargs)
        if self.max_minibatch_size % self._pcount:
            raise ValueError(
                f"{self}: minibatch_size {self.max_minibatch_size} not "
                f"divisible by {self._pcount} processes")
        self._stop_pipeline()
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.input_wait_s = 0.0
        self.epoch_cross_prefetches = 0
        self.pipeline_restarts = 0
        if _metrics.enabled():
            _metrics.prefetch_depth(self.name).set(self.prefetch_depth)

    def stop(self) -> None:
        self._stop_pipeline()
        super().stop()

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        # the prefetch in flight belongs to the trajectory before the
        # restore; the next step rebuilds the pipeline at the restored
        # position (the process's block re-derived from this run's
        # process count, not the snapshot's)
        self._stop_pipeline()

    def _stop_pipeline(self) -> None:
        if self._pipe is not None:
            self._pipe.stop()
            self._pipe = None

    @property
    def pipeline(self) -> _StreamPipeline | None:
        """The live pipeline (None before the first step)."""
        return self._pipe

    def warmup(self) -> None:
        """Start the pipeline at the current position before the first
        step, so that step 1 too is served from a prefetch (optional:
        the first ``host_run`` starts it otherwise)."""
        if self._pipe is not None:
            return
        if self._cursor >= len(self._schedule):
            key = (self.epoch_number + 1, 0)   # the next host_run wraps
        else:
            key = (self.epoch_number, self._cursor)
        self._pipe = _StreamPipeline(self, *key)

    # -- the per-step handoff ---------------------------------------------------
    def _take(self, expected: tuple[int, int]) -> _Item:
        """The staged batch of ``expected``, absorbing up to
        ``engine.reader_restarts`` pipeline deaths this run by rebuilding
        the pipeline at ``expected``.  A rebuilt pipeline reads the same
        indices, so the run goes on bit for bit as an undisturbed one."""
        while True:
            try:
                return self._take_inner(expected)
            except PipelineDead as exc:
                self.pipeline_restarts += 1
                limit = int(root.common.engine.get("reader_restarts", 2))
                self._stop_pipeline()
                if self.pipeline_restarts > limit:
                    raise
                self.warning(
                    "streaming pipeline died (%s) — restart %d/%d at "
                    "epoch %d cursor %d", exc, self.pipeline_restarts,
                    limit, *expected)
                _metrics.loader_pipeline_restarts(self.name).inc()
                _metrics.recoveries("reader_restart").inc()

    def _take_inner(self, expected: tuple[int, int]) -> _Item:
        """The staged batch of ``expected``: from the queue (a hit) or
        after a pipeline (re)start at that position (a miss)."""
        restarted = False
        if self._pipe is None:
            self._pipe = _StreamPipeline(self, *expected)
            restarted = True
        item = self._pipe.take_nowait()
        if item is not None and item.key != expected:
            # a resume or a jump: the stream in flight is another
            # trajectory's; rebuild at the expected position
            self._pipe.release(item)
            self._stop_pipeline()
            self._pipe = _StreamPipeline(self, *expected)
            restarted = True
            item = None
        hit = item is not None
        if item is None:
            with _tracing.TRACER.span(f"input_wait:{self.name}",
                                      cat="loader"):
                t0 = time.perf_counter()
                item = self._pipe.take()
                waited = time.perf_counter() - t0
            if item.key != expected:  # only before a restart
                if restarted:
                    raise RuntimeError(
                        f"{self}: a fresh pipeline at {expected} "
                        f"delivered {item.key}")
                self._pipe.release(item)
                self._stop_pipeline()
                return self._take(expected)
        else:
            waited = 0.0
        self.input_wait_s += waited
        # an epoch's first entry is a recovered stall only when the
        # pipeline got there ahead of the step (a hit)
        crossed = item.crossed_epoch and hit
        if _metrics.enabled():
            _metrics.input_wait_seconds(self.name).observe(waited)
            _metrics.loader_prefetch(
                self.name, "hit" if hit else "miss").inc()
            if crossed:
                _metrics.loader_prefetch(self.name, "epoch_cross").inc()
        if hit:
            self.prefetch_hits += 1
        else:
            self.prefetch_misses += 1
        if crossed:
            self.epoch_cross_prefetches += 1
        return item

    def host_run(self) -> None:
        super().host_run()  # the schedule's bookkeeping
        item = self._take((self.epoch_number, self._cursor - 1))
        self._pipe.deliver(item)
        if _metrics.enabled():
            _metrics.prefetch_ready(self.name).set(self._pipe.ready_batches)


__all__ = ["StreamingLoader", "ShardReader", "write_shards",
           "MANIFEST_NAME", "ShardReadError", "PipelineDead"]
