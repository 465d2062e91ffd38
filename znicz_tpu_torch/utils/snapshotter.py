"""Snapshotter: training-state checkpoints and resume (port of
``znicz_tpu/utils/snapshotter.py``).

The format is the reference's, so a snapshot loads in either package:
``<prefix>_<suffix>.pickle.gz`` holds a gzip'd pickle of plain numpy
and Python data (the workflow's ``state_dict()``: per-unit parameters
and momentum, the loader's schedule, the evaluator's and decision's
counters, the host generator), beside a ``<file>.sha256`` sidecar with
its digest.

- :meth:`Snapshotter.write` writes the file through a temporary name
  and an atomic replace, then the sidecar;
- :meth:`Snapshotter.load` checks the digest (when a sidecar exists),
  the gzip stream and the pickle; on corruption it falls back to the
  newest other snapshot in the same directory that loads, and raises
  :class:`SnapshotCorrupt` only when none does;
- :meth:`Snapshotter.prune` keeps the ``keep_last`` newest good
  snapshots of a prefix.

A :class:`Snapshotter` is a unit: a ``StandardWorkflow`` links it from
the decision and gates it on ``improved``
(``StandardWorkflow.link_snapshotter``), so it fires after each step on
which the decision raised ``improved`` (every ``interval``-th such
time), and names the file by the best validation error,
``min_validation_n_err_pt``.  A failed write is absorbed by default:
it is counted (``znicz_snapshot_failures_total{op=write}``), training
goes on, and ``destination`` keeps pointing at the last good snapshot
(``root.common.engine.snapshot_tolerate_failures = False`` raises
instead).

The ``snapshot.write_fail`` fault site fires inside :meth:`write`, mid
stream, and goes through the same tolerate-and-continue path.  A good
write feeds ``znicz_snapshot_age_seconds{source=snapshot:<prefix>}``, a
callback gauge of the seconds since it.

Multi-process (the reference's discipline): every process gathers the
state (sharded tensors are collectives) and records the same path, and
only process 0 writes and prunes; a call of :meth:`write` on any other
process fences on process 0's ``.sha256`` sidecar
(:meth:`_fence_on_sidecar`, ``engine.snapshot_fence_timeout_s``, default
120 s) and returns the same path, and a failed write on process 0 is
decided on by every process together.  The snapshot directory must be
one that every process sees.
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import logging
import os
import pickle
import time

import numpy as np

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.units import Unit
from znicz_tpu_torch.utils.config import root


class SnapshotCorrupt(RuntimeError):
    """A snapshot failed its digest check (or would not unpickle) and no
    other snapshot in its directory loads either."""


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                return h.hexdigest()
            h.update(buf)


class Snapshotter(Unit):
    """Writes ``<prefix>_<suffix>.pickle.gz`` of its workflow's state
    each time it fires (every ``interval``-th time)."""

    def __init__(self, workflow, name: str = "snapshotter",
                 prefix: str = "snapshot", directory: str | None = None,
                 interval: int = 1, keep_last: int = 5) -> None:
        super().__init__(workflow, name=name)
        self.prefix = prefix
        self.directory = directory or str(root.common.dirs.snapshots)
        self.interval = max(1, int(interval))
        #: snapshots kept on disk (0: all); pruned oldest first after
        #: each good write, so the corruption fallback has somewhere to
        #: land
        self.keep_last = max(0, int(keep_last))
        self.decision = None  # linked by the workflow
        #: the last snapshot written
        self.destination: str | None = None
        self._fire_count = 0

    def snapshot_suffix(self) -> str:
        """The best validation error (``DecisionGD``) or MSE
        (``DecisionMSE``) so far, as the reference names its files."""
        d = self.decision
        if d is not None and getattr(d, "min_validation_n_err_pt", None) \
                is not None and d.loader is not None:
            return f"{d.min_validation_n_err_pt:.2f}pt"
        if d is not None and getattr(d, "min_validation_mse", None) \
                is not None:
            return f"{d.min_validation_mse:.6f}mse"
        return f"e{self._fire_count}"

    def run(self) -> None:
        self._fire_count += 1
        if self._fire_count % self.interval:
            return
        from znicz_tpu_torch.parallel.process_shard import (allgather_sum,
                                                            process_info)
        pidx, pcount = process_info()
        # every process joins the gathers of sharded tensors
        state = self.workflow.state_dict(allow_collective=True)
        suffix = self.snapshot_suffix()
        tolerate = bool(root.common.engine.get(
            "snapshot_tolerate_failures", True))
        write_exc: Exception | None = None
        path = None
        if pidx == 0:
            try:
                path = self.write(state, self.directory, self.prefix,
                                  suffix)
            except Exception as exc:
                if pcount == 1 and not tolerate:
                    raise
                # with peers: decide together below, never strand them
                write_exc = exc
        if pcount > 1:
            failed = allgather_sum(
                np.array([1.0 if write_exc else 0.0]))[0] > 0
            if failed:
                if not tolerate:
                    raise RuntimeError(
                        "snapshot write failed on process 0; every "
                        "process stops together") from write_exc
                write_exc = write_exc or RuntimeError(
                    "snapshot write failed on process 0")
            elif pidx != 0:
                path = self.write(state, self.directory, self.prefix,
                                  suffix)  # the fence on process 0's file
        if write_exc is not None:
            _metrics.snapshot_failures("write").inc()
            _metrics.recoveries("snapshot_write").inc()
            self.warning("snapshot write failed (%s) — continuing; last "
                         "good snapshot remains %s", write_exc,
                         self.destination)
            return
        self.info("snapshot → %s", path)
        self.destination = path
        # the age of the last good snapshot, a callback gauge
        from znicz_tpu_torch.resilience.publisher import \
            mark_artifact_written
        mark_artifact_written(f"snapshot:{self.prefix}")
        if pidx == 0 and self.keep_last:
            self.prune(self.directory, self.prefix, self.keep_last,
                       keep=path)

    @staticmethod
    def _fence_on_sidecar(path: str, entry_mtime: float | None,
                          timeout_s: float) -> str:
        """Wait for process 0's ``.sha256`` sidecar of ``path`` (it lands
        after the data's atomic replace, so it proves a whole file).
        ``entry_mtime`` is the sidecar's mtime before the fence (None:
        absent); a sidecar that was there only counts once its mtime
        moves, or when it is fresh (written within 2 s of the fence's
        start: process 0 finished first), so a stale file of an earlier
        run cannot pass for this one.  The reference's rule."""
        log = logging.getLogger("znicz_tpu_torch.Snapshotter")
        sidecar = f"{path}.sha256"
        entry_wall = time.time()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                mtime = os.path.getmtime(sidecar)
            except OSError:
                mtime = None
            if mtime is not None and (entry_mtime is None
                                      or mtime > entry_mtime
                                      or mtime >= entry_wall - 2.0):
                return path
            time.sleep(0.02)
        if os.path.exists(sidecar) and os.path.exists(path):
            log.warning("sidecar fence on %s timed out after %.0fs but the "
                        "file exists — accepting the (possibly stale) "
                        "file", path, timeout_s)
            return path
        raise OSError(
            f"sidecar fence on {path} timed out after {timeout_s:.0f}s — "
            f"process 0 never completed the write (a snapshot directory "
            f"not shared by every process, or a failed write)")

    @staticmethod
    def write(state: dict, directory: str, prefix: str,
              suffix: str) -> str:
        """Write ``<prefix>_<suffix>.pickle.gz`` atomically, then its
        ``.sha256`` sidecar; returns the path.  In a multi-process run
        only process 0 writes: any other process fences on the sidecar
        (:meth:`_fence_on_sidecar`) and returns the same path."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{prefix}_{suffix}.pickle.gz")
        from znicz_tpu_torch.parallel.process_shard import process_info
        pidx, pcount = process_info()
        if pcount > 1 and pidx != 0:
            try:
                entry_mtime = os.path.getmtime(f"{path}.sha256")
            except OSError:
                entry_mtime = None
            return Snapshotter._fence_on_sidecar(
                path, entry_mtime, float(root.common.engine.get(
                    "snapshot_fence_timeout_s", 120.0)))
        tmp = f"{path}.{os.getpid()}.tmp"
        start = time.perf_counter()
        try:
            with _tracing.TRACER.span("snapshot_save", cat="snapshot"):
                with gzip.open(tmp, "wb") as f:
                    if _faults.fire("snapshot.write_fail") is not None:
                        raise OSError("injected snapshot write failure")
                    pickle.dump(state, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                digest = _sha256_file(tmp)
                os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):  # never leave half a stream behind
                os.unlink(tmp)
            raise
        # the sidecar after the data: a crash between the two leaves a
        # file without a digest (still loadable), never a digest of a
        # file that is not there
        side_tmp = f"{path}.sha256.{os.getpid()}.tmp"
        with open(side_tmp, "w") as f:
            f.write(digest + "\n")
        os.replace(side_tmp, f"{path}.sha256")
        _metrics.snapshot_seconds("save").observe(
            time.perf_counter() - start)
        return path

    @staticmethod
    def _load_verified(path: str) -> dict:
        """One file: its digest (when it has a sidecar), then the
        unpickle; any failure raises :class:`SnapshotCorrupt`."""
        sidecar = f"{path}.sha256"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                want = f.read().strip()
            got = _sha256_file(path)
            if got != want:
                raise SnapshotCorrupt(f"{path}: sha256 {got[:12]}… != "
                                      f"sidecar {want[:12]}…")
        try:
            with gzip.open(path, "rb") as f:
                return pickle.load(f)
        except Exception as exc:  # truncated gzip, bad pickle, ...
            raise SnapshotCorrupt(f"{path}: unreadable snapshot "
                                  f"({exc})") from exc

    @staticmethod
    def load(path: str) -> dict:
        """The state in ``path``, its digest checked; on corruption the
        newest other snapshot of the same directory that loads
        (counting ``znicz_snapshot_failures_total{op=load}`` and
        ``znicz_recoveries_total{kind=snapshot_fallback}``).  Raises
        :class:`SnapshotCorrupt` when nothing there loads."""
        log = logging.getLogger("znicz_tpu_torch.Snapshotter")
        start = time.perf_counter()
        try:
            state = Snapshotter._load_verified(path)
        except SnapshotCorrupt as exc:
            _metrics.snapshot_failures("load").inc()
            log.warning("%s — trying older snapshots", exc)
            fallbacks = [p for p in glob.glob(os.path.join(
                os.path.dirname(path) or ".", "*.pickle.gz"))
                if os.path.abspath(p) != os.path.abspath(path)]
            fallbacks.sort(key=os.path.getmtime, reverse=True)
            for fb in fallbacks:
                try:
                    state = Snapshotter._load_verified(fb)
                except SnapshotCorrupt as fb_exc:
                    log.warning("%s", fb_exc)
                    continue
                log.warning("recovered from older snapshot %s", fb)
                _metrics.recoveries("snapshot_fallback").inc()
                break
            else:
                raise SnapshotCorrupt(f"{path} is corrupt and no fallback "
                                      f"snapshot in its directory "
                                      f"verifies") from exc
        _metrics.snapshot_seconds("load").observe(
            time.perf_counter() - start)
        return state

    @staticmethod
    def prune(directory: str, prefix: str, keep_last: int,
              keep: str | None = None) -> list[str]:
        """Keep the ``keep_last`` newest good ``<prefix>_*.pickle.gz``
        snapshots (and ``keep``); delete the rest and every corrupt one,
        with their sidecars.  A file without a sidecar counts as good,
        as :meth:`load` takes it.  Returns the deleted paths."""
        files = glob.glob(os.path.join(directory, f"{prefix}_*.pickle.gz"))
        files.sort(key=os.path.getmtime, reverse=True)
        good, bad = [], []
        for path in files:
            sidecar = f"{path}.sha256"
            ok = True
            try:
                if os.path.exists(sidecar):
                    with open(sidecar) as f:
                        ok = _sha256_file(path) == f.read().strip()
            except OSError:  # gone meanwhile: leave it alone
                continue
            (good if ok else bad).append(path)
        protected = {os.path.abspath(p) for p in good[:keep_last]}
        if keep:
            protected.add(os.path.abspath(keep))
        deleted = []
        for path in bad + good[keep_last:]:
            if os.path.abspath(path) in protected:
                continue
            try:
                os.unlink(path)
                if os.path.exists(f"{path}.sha256"):
                    os.unlink(f"{path}.sha256")
                deleted.append(path)
            except OSError:
                pass
        return deleted
