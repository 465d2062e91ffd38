"""Launcher: owns the workflow's life from construction to the end of
training (port of ``znicz_tpu/launcher.py``).

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

- multi-process (the reference's distributed mode): ``listen``
  (process 0, the master) or ``master`` (every other process) names the
  coordinator ``host:port``, with ``n_processes`` and ``process_id``;
  or the environment contract of
  :mod:`~znicz_tpu_torch.parallel.distributed` gives all three.  Each
  process starts ``torch.distributed`` (NCCL on the card, one card a
  process; gloo with ``backend="cpu"``) and trains over a
  ``(data, model[, seq])`` mesh of ``n_model`` × ``n_seq`` (the rest on
  ``data``), synchronously, as the reference's SPMD program does.  It
  refuses what would train replicas by accident: the numpy oracle
  cannot join a mesh, and ``n_model``/``n_seq`` > 1 needs distributed
  mode.  Process 0 writes the snapshots; the others fence on them.

- elastic supervision: ``ZNICZ_HEARTBEAT_DIR`` (or
  ``engine.heartbeat_dir``) attaches a
  :class:`~znicz_tpu_torch.resilience.supervisor.WorkerSupervisor` to the
  run (heartbeats, the preemption barrier, the hang watchdog), and
  SIGTERM then asks for the barriered checkpoint at a near step boundary
  instead of the emergency snapshot; ``ZNICZ_RESUME_SNAPSHOT`` names the
  snapshot a restarted gang resumes from, as the
  :class:`~znicz_tpu_torch.resilience.supervisor.ElasticSupervisor` sets
  it.

- ``web_status`` (a port, 0 for a free one): process 0 serves the web
  status page (:class:`~znicz_tpu_torch.web_status.WebStatusServer`) on
  ``web_status_host`` (127.0.0.1 unless given) for the run, with the
  workflow registered; :attr:`Launcher.web_server` is the server, kept
  after the run for its caller to stop.

- ``graphics``: ``False`` turns the plotters' render thread off for the
  run (``root.common.graphics.render``; the plotters still log
  ``events.jsonl``), ``True`` turns it on and starts the process's
  graphics server (:func:`znicz_tpu_torch.graphics.get_server`) before
  the workflow runs; ``None`` leaves the config as it is.  The CLI's
  ``--no-graphics`` passes ``False``.
"""

from __future__ import annotations

import glob
import os
import signal
import traceback
from typing import Any, Callable

from znicz_tpu_torch.backends import (CpuDevice, CudaDevice, Device,
                                      resolve_device)
from znicz_tpu_torch.parallel import distributed
from znicz_tpu_torch.parallel.mesh import make_mesh
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger
from znicz_tpu_torch.utils.snapshotter import Snapshotter

def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class Launcher(Logger):
    """Device selection, distributed bring-up, resume and the run loop
    of one workflow."""

    def __init__(self, backend: str | None = None,
                 snapshot: str | None = None, retries: int = 0,
                 listen: str | None = None, master: str | None = None,
                 n_processes: int | None = None,
                 process_id: int | None = None, n_model: int = 1,
                 chunk: int | None = None, n_seq: int = 1,
                 web_status: int | None = None,
                 web_status_host: str = "127.0.0.1",
                 graphics: bool | None = None,
                 load_kwargs: dict | None = None) -> None:
        super().__init__()
        if listen and master:
            raise ValueError("--listen and --master are exclusive")
        if backend not in (None, "cuda", "cpu", "numpy"):
            raise ValueError(f"backend '{backend}' (cuda, cpu or numpy)")
        self.backend = backend
        if snapshot is None:
            # the elastic restart contract: the gang supervisor names the
            # snapshot to resume from, so the same command line resumes
            snapshot = os.environ.get("ZNICZ_RESUME_SNAPSHOT") or None
        self.snapshot = snapshot
        self.retries = int(retries)
        self.chunk = 1 if chunk is None else int(chunk)
        if self.chunk < 1:
            raise ValueError(f"chunk {chunk}: at least one step a dispatch")
        #: model- and seq-axis sizes of the mesh (1: pure data parallel)
        self.n_model = 1 if n_model is None else int(n_model)
        self.n_seq = int(n_seq)
        self.web_status = web_status  # a port (0: a free one) or None
        self.web_status_host = web_status_host
        self.web_server = None
        self._graphics = graphics
        #: build arguments a driver gives the sample's factory (the
        #: ``--optimize`` trials' plain genes)
        self.load_kwargs = dict(load_kwargs or {})
        self.workflow = None
        self.device = None
        self._snapshot_state: dict | None = None
        self._interrupted = False
        self._old_handlers: dict[int, Any] = {}
        self._worker_supervisor = None
        # distributed mode ---------------------------------------------
        self.coordinator = listen or master
        self.process_id = process_id
        self.n_processes = n_processes
        self.is_master = master is None  # standalone or the --listen one
        if not self.coordinator:
            spec = distributed.env_spec()
            if spec is not None:
                self.coordinator = spec["coordinator_address"]
                self.n_processes = spec.get("num_processes",
                                            self.n_processes)
                if self.process_id is None:
                    self.process_id = spec.get("process_id")
        if self.coordinator:
            if self.process_id is None and listen is not None:
                self.process_id = 0
            if self.backend != "numpy":
                self._init_distributed()

    @property
    def mode(self) -> str:
        if not self.coordinator:
            return "standalone"
        return "master" if self.is_master else "slave"

    @property
    def device_type(self) -> str:
        return "cpu" if self.backend == "cpu" else "cuda"

    def _init_distributed(self) -> None:
        """``torch.distributed`` over the coordinator (the reference's
        ``jax.distributed`` bring-up)."""
        self.info("distributed init (%s, process %s of %s) @ %s",
                  distributed.backend_for(self.device_type),
                  self.process_id, self.n_processes, self.coordinator)
        distributed.ensure_initialized(
            coordinator=self.coordinator, num_processes=self.n_processes,
            process_id=self.process_id, device_type=self.device_type)
        self.is_master = distributed.process_info()[0] == 0

    def shutdown(self) -> None:
        """End distributed mode: the workflow's graphs destroyed, then
        the process group torn down (every process calls this, as every
        process started the group)."""
        if not self.coordinator:
            return
        if self.workflow is not None:
            self.workflow.release_graphs()
        distributed.shutdown()

    def make_device(self):
        """The device the workflow runs on: the card unless the backend
        is ``"cpu"`` or ``"numpy"`` (the numpy oracle); in distributed
        mode this process's card (or CPU rank) with the global mesh."""
        if self.device is None:
            if self.coordinator and self.backend == "numpy":
                raise ValueError(
                    "distributed mode needs the card or -b cpu: the "
                    "host-only numpy oracle cannot join a device mesh "
                    "(each process would silently train an independent "
                    "replica)")
            if not self.coordinator and (self.n_model > 1
                                         or self.n_seq > 1):
                raise ValueError(
                    f"n_model={self.n_model}/n_seq={self.n_seq} requires "
                    f"distributed mode (--listen/--master or the ZNICZ_* "
                    f"environment builds the global mesh); a standalone "
                    f"run would silently ignore it")
            if self.coordinator:
                mesh = make_mesh(n_model=self.n_model, n_seq=self.n_seq,
                                 device_type=self.device_type)
                dev = distributed.local_device(self.device_type)
                cls = CudaDevice if dev.type == "cuda" else CpuDevice
                self.device = cls(dev, mesh=mesh)
            elif self.backend == "numpy":
                self.device = Device.create("numpy")
            else:
                self.device = resolve_device(
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
        self.workflow = factory(**{**self.load_kwargs, **kwargs})
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
        if self._graphics is not None:
            root.common.graphics.render = bool(self._graphics)
            if self._graphics:
                from znicz_tpu_torch import graphics
                graphics.get_server()
        if self.web_status is not None and self.web_server is None \
                and self.is_master:
            from znicz_tpu_torch.web_status import WebStatusServer
            self.web_server = WebStatusServer(
                port=self.web_status, host=self.web_status_host)
        if self.web_server is not None:
            self.web_server.register(workflow)
        device = self.make_device()
        if not workflow.is_initialized:
            workflow.initialize(device=device, **kwargs)
        if self._snapshot_state is not None:
            workflow.load_state(self._snapshot_state)
            self._snapshot_state = None
        from znicz_tpu_torch.resilience import supervisor as _supervisor
        sup_cfg = _supervisor.worker_config()
        if sup_cfg is not None and self._worker_supervisor is None:
            self._worker_supervisor = _supervisor.WorkerSupervisor(
                workflow, is_master=self.is_master, **sup_cfg)
            self._worker_supervisor.attach()
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
            if self._worker_supervisor is not None:
                self._worker_supervisor.detach()
                self._worker_supervisor = None
        return workflow

    # -- failures --------------------------------------------------------
    def _install_signal_handlers(self, workflow) -> None:
        def handler(signum, frame):
            if self._interrupted:  # the second signal: out at once
                raise KeyboardInterrupt
            supervisor = self._worker_supervisor
            if supervisor is not None and signum == signal.SIGTERM:
                # preemption: the whole gang checkpoints at one barrier
                # step boundary and exits EXIT_PREEMPTED (one flag file
                # here, nothing else in the handler)
                self._interrupted = True
                supervisor.request_preempt(f"signal {signum}")
                return
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
