"""Launcher: owns the workflow's life from construction to the end of
training (port of ``znicz_tpu/launcher.py``, one process).

The reference's sample protocol is kept: every sample module exposes
``run(load, main)``; :meth:`Launcher.boot` calls it with
``load(factory, **kwargs)``, which builds the workflow and stages a
snapshot to resume from, and ``main(**kwargs)``, which initializes the
workflow on the device, loads the staged state and trains it.

- The device comes from :func:`znicz_tpu_torch.backends.resolve_device`:
  ``backend=None`` (or ``"cuda"``) is the card, and raises when there
  is none; the CPU only when ``backend="cpu"`` asks for it, the numpy
  oracle only when ``backend="numpy"`` does.
- ``retries > 0``: a run that raises is started again, resuming from
  the workflow's newest snapshot (:meth:`latest_snapshot`).
- ``chunk > 1``: the workflow trains through ``run_chunked(chunk)``,
  up to ``chunk`` steps a region dispatch (on the card, replays of the
  step's CUDA graph with no host work between them).
- SIGINT and SIGTERM write the emergency snapshot
  ``<workflow name>_interrupted`` into ``root.common.dirs.snapshots``,
  then stop the workflow at the next step boundary; a second signal
  interrupts at once.

Not ported yet: the multi-process modes (``listen``, ``master``,
``n_processes``, ``process_id``, ``n_model``: ROADMAP A9), the graphics
server, the web status page and the worker supervisor (A12, A13).  The
first raise :class:`NotImplementedError`; the others are not offered.
"""

from __future__ import annotations

import glob
import os
import signal
import traceback
from typing import Any, Callable

from znicz_tpu_torch.backends import Device, resolve_device
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger
from znicz_tpu_torch.utils.snapshotter import Snapshotter

def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class Launcher(Logger):
    """Device selection, resume and the run loop of one workflow."""

    def __init__(self, backend: str | None = None,
                 snapshot: str | None = None, retries: int = 0,
                 listen: str | None = None, master: str | None = None,
                 n_processes: int | None = None,
                 process_id: int | None = None, n_model: int = 1,
                 chunk: int | None = None) -> None:
        super().__init__()
        if listen and master:
            raise ValueError("--listen and --master are exclusive")
        multi = {"listen": listen, "master": master,
                 "n_processes": n_processes, "process_id": process_id,
                 "n_model": None if n_model == 1 else n_model}
        given = [arg for arg, value in multi.items() if value is not None]
        if given:
            raise not_ported(f"Launcher({given[0]}=...): multi-process "
                             f"training", "A9")
        if backend not in (None, "cuda", "cpu", "numpy"):
            raise ValueError(f"backend '{backend}' (cuda, cpu or numpy)")
        self.backend = backend
        self.snapshot = snapshot
        self.retries = int(retries)
        self.chunk = 1 if chunk is None else int(chunk)
        if self.chunk < 1:
            raise ValueError(f"chunk {chunk}: at least one step a dispatch")
        self.workflow = None
        self.device = None
        self._snapshot_state: dict | None = None
        self._interrupted = False
        self._old_handlers: dict[int, Any] = {}

    def make_device(self):
        """The device the workflow runs on: the card unless the backend
        is ``"cpu"`` or ``"numpy"`` (the numpy oracle)."""
        if self.device is None:
            self.device = Device.create("numpy") \
                if self.backend == "numpy" else resolve_device(
                    "cpu" if self.backend == "cpu" else None)
        return self.device

    # -- the sample protocol: run(load, main) ---------------------------
    def boot(self, run_fn: Callable):
        """Drive a sample module's ``run(load, main)``."""
        run_fn(self._load, self._main)
        if self.workflow is None:
            raise RuntimeError(
                "run(load, main) never called load(factory, ...)")
        return self.workflow

    def _load(self, factory: Callable, **kwargs):
        """Build the workflow and stage the snapshot to resume from;
        returns ``(workflow, snapshot_was_loaded)``."""
        self.workflow = factory(**kwargs)
        loaded = False
        if self.snapshot:
            self._snapshot_state = Snapshotter.load(self.snapshot)
            loaded = True
            self.info("staged snapshot %s", self.snapshot)
        return self.workflow, loaded

    def _main(self, **kwargs) -> None:
        wf = self.workflow
        if wf is None:
            raise RuntimeError("main() called before load()")
        attempt = 0
        while True:
            try:
                self.run_workflow(wf, **kwargs)
                return
            except KeyboardInterrupt:
                raise
            except Exception:
                attempt += 1
                if attempt > self.retries:
                    raise
                latest = self.latest_snapshot(wf)
                self.warning("workflow crashed (attempt %d/%d):\n%s",
                             attempt, self.retries, traceback.format_exc())
                if latest:
                    self.info("auto-resume from %s", latest)
                    self._snapshot_state = Snapshotter.load(latest)

    def run_workflow(self, workflow, **kwargs):
        """Initialize, load the staged snapshot, then run, with the
        signal handlers that write the emergency snapshot."""
        device = self.make_device()
        if not workflow.is_initialized:
            workflow.initialize(device=device, **kwargs)
        if self._snapshot_state is not None:
            workflow.load_state(self._snapshot_state)
            self._snapshot_state = None
        self._install_signal_handlers(workflow)
        try:
            if self.chunk > 1 and hasattr(workflow, "run_chunked"):
                workflow.run_chunked(self.chunk)
            else:
                workflow.run()
        except KeyboardInterrupt:
            self._emergency_snapshot(workflow)
            raise
        finally:
            self._restore_signal_handlers()
        return workflow

    # -- failures --------------------------------------------------------
    def _install_signal_handlers(self, workflow) -> None:
        def handler(signum, frame):
            if self._interrupted:  # the second signal: out at once
                raise KeyboardInterrupt
            self._interrupted = True
            self.warning("signal %d: emergency snapshot + stop", signum)
            self._emergency_snapshot(workflow)
            workflow.stop()

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self._old_handlers[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread (test workers)
                pass

    def _restore_signal_handlers(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._old_handlers.clear()
        self._interrupted = False

    def _emergency_snapshot(self, workflow) -> str | None:
        try:
            path = Snapshotter.write(
                workflow.state_dict(), str(root.common.dirs.snapshots),
                workflow.name, "interrupted")
            self.info("emergency snapshot → %s", path)
            return path
        except Exception:  # best effort on the way out
            self.logger.exception("emergency snapshot failed")
            return None

    def latest_snapshot(self, workflow) -> str | None:
        """The newest snapshot of this workflow: its snapshotter's last
        file, else the newest ``<prefix>_*.pickle.gz`` of its
        snapshotter's prefix or its name (the emergency snapshot's), in
        its snapshotter's directory or ``root.common.dirs.snapshots``."""
        snap = getattr(workflow, "snapshotter", None)
        if snap is not None and snap.destination:
            return snap.destination
        directories = {str(root.common.dirs.snapshots)}
        prefixes = {workflow.name}
        if snap is not None:
            prefixes.add(snap.prefix)
            directories.add(snap.directory)
        files: list[str] = []
        for d in directories:
            for prefix in prefixes:
                files += glob.glob(os.path.join(d, f"{prefix}_*.pickle.gz"))
        files.sort(key=os.path.getmtime)
        return files[-1] if files else None

    def stop(self) -> None:
        if self.workflow is not None:
            self.workflow.stop()
