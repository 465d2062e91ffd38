"""Elastic supervision: heartbeats, the checkpoint on a preemption
signal, restarts from the newest good snapshot on the surviving
processes (port of ``znicz_tpu/resilience/supervisor.py``).

The reference's pieces, over the port's process group
(:mod:`~znicz_tpu_torch.parallel.distributed`: gloo on the CPU, NCCL on
the card, one card a process):

- :class:`HeartbeatWriter`: every process beats ``(step, wall clock)``
  into a channel the coordinator reads (one JSON file a process in
  ``ZNICZ_HEARTBEAT_DIR``), a thread keeping the clock fresh between
  steps;
- :class:`HeartbeatMonitor`: the coordinator's reader, which declares a
  process lost after ``engine.heartbeat_timeout_s`` without a beat, or
  stalled when its beats flow and its step does not move, and feeds
  ``znicz_heartbeat_age_seconds{process}`` (the gauges ``/readyz``
  reads);
- :class:`WorkerSupervisor`: what the launcher attaches in each worker
  (:func:`worker_config`): a beat at every step boundary, the
  ``host.loss``, ``host.preempt`` and ``heartbeat.stall`` drill sites,
  SIGTERM → a *barriered* checkpoint (every process reaches the same
  step boundary, process 0 writes the snapshot with its sha256
  sidecar, the others fence on the sidecar, as
  :meth:`~znicz_tpu_torch.utils.snapshotter.Snapshotter.write` does),
  then :class:`Preempted` (exit :data:`EXIT_PREEMPTED`), and a watchdog
  that exits :data:`EXIT_PEER_LOST` when no step boundary comes within
  ``engine.collective_timeout_s`` (a peer is gone and a collective will
  never complete);
- :class:`ElasticSupervisor`: the gang owner, which spawns one worker a
  process under the ``ZNICZ_*`` environment contract, watches exits and
  heartbeats, classifies each loss (``znicz_host_losses_total{kind}``),
  stops the rest of the gang and starts it again on the survivors from
  the newest digest-checked snapshot (:func:`newest_good_snapshot`,
  ``znicz_elastic_restarts_total``).

Every wait here is on an event, a file or an exit code; the timeouts
are the supervisor's own settings.  The gang supervisor is also the
gang's metrics folder: each poll folds the heartbeat channel into a
:class:`~znicz_tpu_torch.observe.federation.Federator` named
``elastic`` (``znicz_fed_step`` and ``znicz_fed_heartbeat_age_seconds``
by member), so one scrape of the supervisor says which worker is
behind.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from typing import Callable, Sequence

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import recorder as _recorder
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.utils.config import register_defaults, root
from znicz_tpu_torch.utils.logger import Logger

register_defaults("common", {"engine": {
    "heartbeat_interval_s": 1.0, "heartbeat_timeout_s": 30.0,
    "preempt_barrier_steps": 4}})

#: gang exit code after a successful checkpoint-on-signal (EX_TEMPFAIL:
#: "resumable — relaunch me on the surviving host set")
EXIT_PREEMPTED = 75
#: self-watchdog exit code: this process's step stopped making progress
#: past ``engine.collective_timeout_s`` — a peer is gone and the
#: in-flight collective will never complete
EXIT_PEER_LOST = 113
#: the SDC sentinel confirmed THIS process's chip computes
#: wrong values — the gang supervisor must blocklist this host and
#: restart the survivors from the PRE-divergence snapshot (the
#: sentinel annotated its path into the heartbeat channel)
EXIT_SDC = 97

#: env channel shared by Launcher / workers / gang supervisor
ENV_HEARTBEAT_DIR = "ZNICZ_HEARTBEAT_DIR"
ENV_RESUME_SNAPSHOT = "ZNICZ_RESUME_SNAPSHOT"
ENV_ELASTIC_ATTEMPT = "ZNICZ_ELASTIC_ATTEMPT"

_PREEMPT_FLAG = "preempt.json"


class PeerLost(RuntimeError):
    """A peer process died and the in-flight collective can never
    complete (surfaced by the watchdog instead of an infinite hang)."""


class Preempted(SystemExit):
    """Raised after a successful checkpoint-on-signal; subclasses
    ``SystemExit`` so the Launcher's crash-retry loop never swallows it
    and an unhandled instance exits the process with
    :data:`EXIT_PREEMPTED` (the gang supervisor's "resumable" code)."""

    def __init__(self, snapshot_path: str | None = None) -> None:
        super().__init__(EXIT_PREEMPTED)
        self.snapshot_path = snapshot_path


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh)
    os.replace(tmp, path)


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):  # missing / mid-replace torn read
        return None


def heartbeat_path(directory: str, process_index: int) -> str:
    return os.path.join(directory, f"hb_{process_index:04d}.json")


# ----------------------------------------------------------------------
# per-process heartbeat writer
# ----------------------------------------------------------------------
class HeartbeatWriter(Logger):
    """Beats ``{process, step, time, ...}`` into the channel file.

    A daemon thread refreshes the wall-clock every ``interval_s`` even
    while the step counter is frozen — that is what lets the monitor
    tell "host vanished" (stale time) from "host up, step hung in a
    collective" (fresh time, stale step).  :meth:`beat` is the
    step-boundary update; :meth:`annotate` rides extra fields (resume
    position, checkpoint counts) the gang supervisor folds into its
    own registry."""

    def __init__(self, directory: str, process_index: int,
                 interval_s: float = 1.0, **kwargs) -> None:
        super().__init__(**kwargs)
        self.directory = directory
        self.process_index = int(process_index)
        self.interval_s = max(0.05, float(interval_s))
        self.path = heartbeat_path(directory, self.process_index)
        self._lock = threading.Lock()
        self._step = 0
        self._extra: dict = {}
        self._frozen = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self._write()
            self._thread = threading.Thread(
                target=self._loop, name=f"heartbeat-{self.process_index}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._write()  # final state (exit annotations) lands

    # -- updates --------------------------------------------------------
    def beat(self, step: int) -> None:
        """Step-boundary beat: record progress and persist now (the
        interval thread only keeps wall-clock fresh between steps)."""
        with self._lock:
            if not self._frozen:
                self._step = int(step)
        self._write()

    def annotate(self, **fields) -> None:
        with self._lock:
            self._extra.update(fields)
        self._write()

    def freeze(self) -> None:
        """Chaos hook (``heartbeat.stall``): keep wall-clock beats
        flowing but never advance the step counter again — the exact
        signature of a process hung inside a collective."""
        with self._lock:
            self._frozen = True

    @property
    def step(self) -> int:
        return self._step

    # -- plumbing -------------------------------------------------------
    def _payload(self) -> dict:
        with self._lock:
            payload = {"process": self.process_index, "step": self._step,
                       "time": time.time(), "pid": os.getpid()}
            payload.update(self._extra)
        return payload

    def _write(self) -> None:
        try:
            _atomic_write_json(self.path, self._payload())
        except OSError as exc:  # channel fs hiccup: beat again next tick
            self.warning("heartbeat write failed: %s", exc)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()


# ----------------------------------------------------------------------
# coordinator-side monitor
# ----------------------------------------------------------------------
class HeartbeatMonitor(Logger):
    """Reads every process's channel file and classifies liveness.

    ``poll()`` returns ``{process: {"status", "age_s", "step",
    "step_age_s"}}`` where status is ``ok`` / ``starting`` (never
    beaten, within the bring-up grace) / ``missing`` / ``stale`` (no
    beat for ``timeout_s``) / ``stalled`` (beats flow, step frozen for
    ``stall_timeout_s``).  ``dead()`` lists the processes a supervisor
    must act on.  ``register_gauges()`` feeds the canonical
    ``znicz_heartbeat_age_seconds{process}`` callback gauges so
    ``/metrics`` and ``/readyz`` expose peer ages from the same
    channel."""

    def __init__(self, directory: str, n_processes: int,
                 timeout_s: float = 30.0,
                 stall_timeout_s: float | None = None,
                 start_grace_s: float | None = None, **kwargs) -> None:
        super().__init__(**kwargs)
        self.directory = directory
        self.n_processes = int(n_processes)
        self.timeout_s = float(timeout_s)
        self.stall_timeout_s = float(
            stall_timeout_s if stall_timeout_s is not None
            else max(timeout_s, 2.0))
        #: bring-up (imports, the process group, the first capture) can
        #: dwarf the steady-state timeout; a process that has NEVER
        #: beaten only counts dead after this grace
        self.start_grace_s = float(
            start_grace_s if start_grace_s is not None
            else max(4 * self.timeout_s, 60.0))
        self._t0 = time.time()
        #: per-process (step, first-seen-at-this-step) for stall detect
        self._step_seen: dict[int, tuple[int, float]] = {}

    def read(self, process_index: int) -> dict | None:
        return _read_json(heartbeat_path(self.directory, process_index))

    def age_of(self, process_index: int) -> float:
        """Seconds since the process last beat (inf when never seen) —
        the ``znicz_heartbeat_age_seconds`` gauge body."""
        hb = self.read(process_index)
        if hb is None:
            return float("inf")
        return max(0.0, time.time() - float(hb.get("time", 0.0)))

    def poll(self, now: float | None = None) -> dict[int, dict]:
        now = time.time() if now is None else now
        out: dict[int, dict] = {}
        for i in range(self.n_processes):
            hb = self.read(i)
            if hb is None:
                grace_left = self.start_grace_s - (now - self._t0)
                out[i] = {"status": "starting" if grace_left > 0
                          else "missing",
                          "age_s": float("inf"), "step": None,
                          "step_age_s": float("inf")}
                continue
            age = max(0.0, now - float(hb.get("time", 0.0)))
            step = int(hb.get("step", 0))
            seen = self._step_seen.get(i)
            if seen is None or seen[0] != step:
                self._step_seen[i] = (step, now)
                step_age = 0.0
            else:
                step_age = now - seen[1]
            if age > self.timeout_s:
                status = "stale"
            elif step_age > self.stall_timeout_s and step > 0:
                status = "stalled"
            else:
                status = "ok"
            out[i] = {"status": status, "age_s": age, "step": step,
                      "step_age_s": step_age, "hb": hb}
        return out

    def dead(self, now: float | None = None) -> list[tuple[int, str]]:
        """``[(process, kind)]`` needing supervisor action — kind is
        ``loss`` (missing/stale) or ``stall`` (frozen step counter)."""
        out = []
        for i, st in self.poll(now).items():
            if st["status"] in ("missing", "stale"):
                out.append((i, "loss"))
            elif st["status"] == "stalled":
                out.append((i, "stall"))
        return out

    def register_gauges(self) -> None:
        for i in range(self.n_processes):
            _metrics.heartbeat_age_seconds(i).set_function(
                lambda i=i: self.age_of(i))


# ----------------------------------------------------------------------
# preemption flag (the cross-process checkpoint barrier request)
# ----------------------------------------------------------------------
def request_preempt_flag(directory: str, barrier_step: int,
                         requested_by: int, reason: str) -> str:
    """Publish the gang-wide checkpoint request.  First writer wins —
    a flag already on disk (another host was preempted in the same
    window) is left untouched so every process agrees on ONE barrier
    step."""
    path = os.path.join(directory, _PREEMPT_FLAG)
    if not os.path.exists(path):
        _atomic_write_json(path, {
            "barrier_step": int(barrier_step),
            "requested_by": int(requested_by),
            "reason": reason, "time": time.time()})
    return path


def preempt_flag(directory: str) -> dict | None:
    return _read_json(os.path.join(directory, _PREEMPT_FLAG))


# ----------------------------------------------------------------------
# in-process supervision (attached by the Launcher)
# ----------------------------------------------------------------------
def worker_config() -> dict | None:
    """The Launcher's attach decision: the env channel
    (``ZNICZ_HEARTBEAT_DIR``) or ``engine.heartbeat_dir`` turns
    supervision on; returns the ctor kwargs or None."""
    directory = os.environ.get(ENV_HEARTBEAT_DIR) \
        or root.common.engine.get("heartbeat_dir", None)
    if not directory:
        return None
    return {"directory": str(directory)}


class WorkerSupervisor(Logger):
    """One workflow run's in-process supervision.

    ``attach()`` hooks the workflow's step boundary (fired by the
    Decision unit every step / chunk): each boundary beats the
    heartbeat, fires the elastic chaos sites, polls the preempt flag
    and — once a preemption is pending and the barrier step is reached
    — executes the checkpoint-on-signal and raises
    :class:`Preempted`.  A watchdog thread bounds the time between
    step boundaries (``engine.collective_timeout_s``, unset = off):
    when a peer dies mid-collective this process logs
    :class:`PeerLost` and exits :data:`EXIT_PEER_LOST` promptly
    instead of hanging in gloo or NCCL forever."""

    def __init__(self, workflow, directory: str | None = None,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 is_master: bool | None = None,
                 heartbeat_interval_s: float | None = None,
                 collective_timeout_s: float | None = None,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        from znicz_tpu_torch.parallel.distributed import process_info
        pidx, pcount = process_info()
        self.workflow = workflow
        self.directory = directory
        self.process_index = pidx if process_index is None \
            else int(process_index)
        self.process_count = pcount if process_count is None \
            else int(process_count)
        self.is_master = (self.process_index == 0) if is_master is None \
            else bool(is_master)
        engine = root.common.engine
        interval = heartbeat_interval_s if heartbeat_interval_s is not None \
            else engine.get("heartbeat_interval_s", 1.0)
        self.collective_timeout_s = collective_timeout_s \
            if collective_timeout_s is not None \
            else engine.get("collective_timeout_s", None)
        self.preempt_barrier_steps = int(
            engine.get("preempt_barrier_steps", 4))
        self.step = 0
        self.writer: HeartbeatWriter | None = None
        self.monitor: HeartbeatMonitor | None = None
        if directory:
            self.writer = HeartbeatWriter(
                directory, self.process_index, interval_s=float(interval))
            attempt = os.environ.get(ENV_ELASTIC_ATTEMPT)
            if attempt is not None:
                self.writer.annotate(attempt=int(attempt))
            if self.is_master:
                # coordinator-side monitor: REPORT-ONLY in-worker (the
                # gang supervisor owns restarts) — feeds the per-peer
                # age gauges /metrics + /readyz expose
                self.monitor = HeartbeatMonitor(
                    directory, self.process_count,
                    timeout_s=float(engine.get("heartbeat_timeout_s",
                                               30.0)),
                    stall_timeout_s=engine.get(
                        "heartbeat_stall_timeout_s", None))
                self.monitor.register_gauges()
        self._preempt: dict | None = None
        self._preempt_lock = threading.Lock()
        self._attached = False
        self._last_boundary = time.time()
        self._watchdog_stop = threading.Event()
        self._watchdog: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------
    def attach(self) -> "WorkerSupervisor":
        if self._attached:
            return self
        self.workflow.add_step_hook(self.on_step)
        # the SDC sentinel reaches the heartbeat channel through this
        # back-reference (quarantine annotations + EXIT_SDC)
        self.workflow._worker_supervisor = self
        if self.writer is not None:
            # resume-position attestation: attach runs after any
            # snapshot restore, so the loader's position IS where this
            # attempt resumed — the gang supervisor folds it into its
            # registry as the drill's `resumed_step`
            loader = getattr(self.workflow, "loader", None)
            schedule = getattr(loader, "_schedule", None)
            if loader is not None and schedule is not None:
                try:
                    self.writer.annotate(
                        resumed_step=(int(loader.epoch_number)
                                      * len(schedule)
                                      + int(loader._cursor)),
                        start_epoch=int(loader.epoch_number),
                        start_cursor=int(loader._cursor))
                except (TypeError, ValueError):  # uninitialized loader
                    pass
            self.writer.start()
        if self.collective_timeout_s:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="collective-watchdog",
                daemon=True)
            self._watchdog.start()
        self._attached = True
        return self

    def detach(self) -> None:
        if not self._attached:
            return
        self.workflow.remove_step_hook(self.on_step)
        if getattr(self.workflow, "_worker_supervisor", None) is self:
            self.workflow._worker_supervisor = None
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
            self._watchdog = None
        if self.writer is not None:
            self.writer.stop()
        self._attached = False

    # -- the step boundary ---------------------------------------------
    def on_step(self) -> None:
        self.step += 1
        self._last_boundary = time.time()
        if self.writer is not None:
            self.writer.beat(self.step)
        if _faults.active() is not None:
            if _faults.fire("host.loss",
                            process=self.process_index) is not None:
                # "the host vanished": no drain, no snapshot, no exit
                # handlers — exactly what a real loss looks like to the
                # survivors and the gang supervisor
                self.error("host.loss injected at step %d — dying hard",
                           self.step)
                os._exit(1)
            if _faults.fire("host.preempt",
                            process=self.process_index) is not None:
                self.request_preempt("host.preempt fault")
            payload = _faults.fire("heartbeat.stall",
                                   process=self.process_index)
            if payload is not None:
                sleep_s = float(payload.get("sleep_s", 3600.0))
                self.warning("heartbeat.stall injected at step %d — "
                             "freezing step counter and blocking %gs",
                             self.step, sleep_s)
                if self.writer is not None:
                    self.writer.freeze()
                time.sleep(sleep_s)
        self._poll_preempt()
        pre = self._preempt
        if pre is not None and self.step >= int(pre["barrier_step"]):
            self.checkpoint_on_signal()

    def _poll_preempt(self) -> None:
        if self._preempt is not None or self.directory is None:
            return
        flag = preempt_flag(self.directory)
        if flag is None:
            return
        with self._preempt_lock:
            self._preempt = flag
        barrier = int(flag["barrier_step"])
        if self.step > barrier and self.process_count > 1:
            # lockstep was violated (flag observed too late) — a
            # mismatched collective checkpoint would deadlock the
            # gang; die loudly and let the supervisor restart from the
            # last periodic snapshot instead
            self.error("preempt barrier step %d already passed at "
                       "step %d — exiting without checkpoint",
                       barrier, self.step)
            os._exit(EXIT_PEER_LOST)

    # -- preemption -----------------------------------------------------
    def request_preempt(self, reason: str) -> None:
        """SIGTERM / ``host.preempt`` entry: announce the gang-wide
        barrier step (this process's current step + margin, so every
        lockstep peer reaches it) and join it ourselves.  Signal-safe:
        no device work, one tiny file write."""
        with self._preempt_lock:
            if self._preempt is not None:
                return
            margin = 1 if self.process_count == 1 \
                else self.preempt_barrier_steps
            flag = {"barrier_step": self.step + margin,
                    "requested_by": self.process_index,
                    "reason": reason, "time": time.time()}
            if self.directory is not None:
                request_preempt_flag(self.directory, flag["barrier_step"],
                                     self.process_index, reason)
                # first writer wins: re-read so a concurrent request
                # from another host leaves ONE agreed barrier
                flag = preempt_flag(self.directory) or flag
            self._preempt = flag
        self.warning("preemption requested (%s): checkpoint-on-signal "
                     "at step boundary >= %d", reason,
                     self._preempt["barrier_step"])

    def checkpoint_on_signal(self) -> None:
        """The barriered checkpoint: every process gathers state at the
        SAME step boundary (collective reads are legal — the gang is in
        lockstep), process 0 writes the sha256-sidecar snapshot, the
        rest fence on the sidecar appearing, and everyone exits
        :data:`EXIT_PREEMPTED` via :class:`Preempted`."""
        from znicz_tpu_torch.utils.snapshotter import Snapshotter
        wf = self.workflow
        pre = self._preempt or {}
        snap = getattr(wf, "snapshotter", None)
        directory = snap.directory if snap is not None \
            else str(root.common.dirs.snapshots)
        prefix = snap.prefix if snap is not None else wf.name
        suffix = f"preempt_s{int(pre.get('barrier_step', self.step))}"
        state = wf.state_dict(allow_collective=True)
        path = Snapshotter.write(state, directory, prefix, suffix)
        if self.is_master \
                and _faults.fire("checkpoint.signal_corrupt") is not None:
            with open(path, "r+b") as fh:  # digest now lies about this
                fh.seek(max(0, os.path.getsize(path) // 2))
                fh.write(b"\xde\xad\xbe\xef")
            self.warning("checkpoint.signal_corrupt injected on %s",
                         path)
        _metrics.checkpoint_on_signal().inc()
        if self.writer is not None:
            self.writer.annotate(
                checkpoint_on_signal=1, checkpoint_path=path,
                checkpoint_step=self.step)
        self.warning("checkpoint-on-signal complete at step %d → %s — "
                     "exiting %d", self.step, path, EXIT_PREEMPTED)
        wf.stop()
        raise Preempted(path)

    # -- watchdog -------------------------------------------------------
    def _watchdog_loop(self) -> None:
        timeout = float(self.collective_timeout_s)
        while not self._watchdog_stop.wait(min(1.0, timeout / 4)):
            if self.step == 0:
                continue  # bring-up / first compile: unbounded
            stall = time.time() - self._last_boundary
            if stall > timeout:
                self.error(
                    "PeerLost: no step boundary for %.1fs (> "
                    "collective_timeout_s=%.1fs) — a peer is gone and "
                    "the in-flight collective cannot complete; exiting "
                    "%d for the elastic supervisor", stall, timeout,
                    EXIT_PEER_LOST)
                if self.writer is not None:
                    self.writer.annotate(peer_lost=True)
                # a thread cannot interrupt a blocked gloo/NCCL call —
                # prompt suicide IS the detectable surfacing
                os._exit(EXIT_PEER_LOST)


# ----------------------------------------------------------------------
# gang supervisor (the elastic restart owner)
# ----------------------------------------------------------------------
def newest_good_snapshot(directory: str, prefix: str | None = None
                         ) -> str | None:
    """Newest ``*.pickle.gz`` whose sha256 sidecar verifies (sidecarless
    files — the crash window — count good, matching
    ``Snapshotter._load_verified``); None when nothing qualifies."""
    import glob as _glob

    from znicz_tpu_torch.utils.snapshotter import _sha256_file
    pattern = f"{prefix}_*.pickle.gz" if prefix else "*.pickle.gz"
    files = _glob.glob(os.path.join(directory, pattern))
    files.sort(key=os.path.getmtime, reverse=True)
    for path in files:
        sidecar = f"{path}.sha256"
        try:
            if os.path.exists(sidecar):
                with open(sidecar) as fh:
                    if _sha256_file(path) != fh.read().strip():
                        continue
            return path
        except OSError:
            continue
    return None


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ElasticSupervisor(Logger):
    """Owns the worker gang: spawn → monitor → classify → restart.

    ``argv_for(process_id, n_processes, attempt)`` builds each worker's
    command line; the supervisor provides the env contract
    (``ZNICZ_COORDINATOR`` on a fresh port per attempt,
    ``ZNICZ_NUM_PROCESSES`` / ``ZNICZ_PROCESS_ID``,
    ``ZNICZ_HEARTBEAT_DIR`` per attempt, ``ZNICZ_ELASTIC_ATTEMPT`` and
    — after the first attempt — ``ZNICZ_RESUME_SNAPSHOT`` pointing at
    the newest digest-verified snapshot).  ``fault_env`` is applied to
    attempt 0 only, so a seeded chaos recipe injects exactly once and
    the restarted gang runs clean.

    Failure classification (counted as
    ``znicz_host_losses_total{kind}``):

    - ``preempt`` — a child exited :data:`EXIT_PREEMPTED` after the
      barriered checkpoint; the gang drains on its own;
    - ``stall`` — heartbeats flow but a step counter froze past the
      stall timeout (hung collective / seized host);
    - ``loss`` — a child died (any other nonzero exit) or its
      heartbeat went stale/missing;
    - ``sdc`` — a child exited :data:`EXIT_SDC` after the
      integrity sentinel confirmed its chip computes wrong values:
      the culprit is BLOCKLISTED and the restart resumes from the
      gang-attested PRE-divergence snapshot (heartbeat annotation
      ``sdc_last_good``), not the newest one — snapshots written
      after the divergence may already carry the corruption.

    Every restart shrinks the gang by the lost processes and relaunches
    on the surviving host set (``znicz_elastic_restarts_total``)."""

    def __init__(self, argv_for: Callable[[int, int, int], Sequence[str]],
                 n_processes: int, work_dir: str,
                 snapshot_dir: str, snapshot_prefix: str | None = None,
                 heartbeat_timeout_s: float = 10.0,
                 stall_timeout_s: float | None = None,
                 start_grace_s: float | None = None,
                 poll_interval_s: float = 0.25,
                 drain_s: float = 30.0,
                 max_restarts: int = 3,
                 env: dict | None = None,
                 fault_env: dict | None = None,
                 initial_snapshot: str | None = None, **kwargs) -> None:
        super().__init__(**kwargs)
        #: snapshot handed to attempt 0 (restart attempts always pick
        #: the newest good one from snapshot_dir) — the parity drill's
        #: reference arm resumes a 1-process gang from a pinned file
        self.initial_snapshot = initial_snapshot
        self.argv_for = argv_for
        self.n_processes = int(n_processes)
        self.work_dir = work_dir
        self.snapshot_dir = snapshot_dir
        self.snapshot_prefix = snapshot_prefix
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.stall_timeout_s = stall_timeout_s
        self.start_grace_s = start_grace_s
        self.poll_interval_s = float(poll_interval_s)
        self.drain_s = float(drain_s)
        self.max_restarts = int(max_restarts)
        self.env = dict(env or {})
        self.fault_env = dict(fault_env or {})
        self.monitor: HeartbeatMonitor | None = None
        #: run() summary (also returned): attempts, restarts, losses by
        #: kind, resume snapshots, checkpoint-on-signal folds, ...
        self.summary: dict = {}
        #: process indices confirmed corrupt by the SDC
        #: sentinel — never relaunched (the "corrupt-chip quarantine")
        self.blocklist: set[int] = set()
        #: pre-divergence snapshot annotated by the gang at an SDC
        #: quarantine — overrides newest_good_snapshot for the restart
        self._sdc_resume: str | None = None
        os.makedirs(work_dir, exist_ok=True)

    # -- one attempt ----------------------------------------------------
    def _spawn(self, attempt: int, n: int, hb_dir: str,
               resume: str | None) -> list[subprocess.Popen]:
        port = _free_port()
        base = dict(os.environ)
        for key, val in self.env.items():
            if val is None:  # None = scrub from the inherited env
                base.pop(key, None)
            else:
                base[key] = str(val)
        if attempt == 0:
            base.update(self.fault_env)
        base["ZNICZ_COORDINATOR"] = f"127.0.0.1:{port}"
        base["ZNICZ_NUM_PROCESSES"] = str(n)
        base[ENV_HEARTBEAT_DIR] = hb_dir
        base[ENV_ELASTIC_ATTEMPT] = str(attempt)
        if resume:
            base[ENV_RESUME_SNAPSHOT] = resume
        else:
            base.pop(ENV_RESUME_SNAPSHOT, None)
        procs = []
        for pid in range(n):
            env = dict(base)
            env["ZNICZ_PROCESS_ID"] = str(pid)
            log_path = os.path.join(
                self.work_dir, f"worker_a{attempt}_p{pid}.log")
            log_fh = open(log_path, "w")
            proc = subprocess.Popen(
                list(self.argv_for(pid, n, attempt)),
                env=env, stdout=log_fh, stderr=subprocess.STDOUT)
            proc._znicz_log = log_path  # type: ignore[attr-defined]
            proc._znicz_log_fh = log_fh  # type: ignore[attr-defined]
            procs.append(proc)
        self.info("attempt %d: spawned %d worker(s) @ port %d "
                  "(resume=%s)", attempt, n, port, resume or "fresh")
        return procs

    @staticmethod
    def _kill(procs: list[subprocess.Popen]) -> None:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + 5.0
        for proc in procs:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)

    @staticmethod
    def _close_logs(procs: list[subprocess.Popen]) -> None:
        for proc in procs:
            fh = getattr(proc, "_znicz_log_fh", None)
            if fh is not None:
                fh.close()

    def _fold_heartbeats(self, hb_dir: str, n: int) -> None:
        """Worker-side attestations ride the heartbeat channel; fold
        them into THIS process's registry so the dryrun scrape sees one
        coherent story (checkpoint-on-signal counts, resume steps,
        SDC verdicts)."""
        sdc_detected: dict[str, float] = {}
        sdc_injected: dict[str, float] = {}
        for i in range(n):
            hb = _read_json(heartbeat_path(hb_dir, i))
            if not hb:
                continue
            if hb.get("checkpoint_on_signal"):
                _metrics.checkpoint_on_signal().inc(
                    float(hb["checkpoint_on_signal"]))
            if hb.get("resumed_step") is not None:
                self.summary["resumed_step"] = int(hb["resumed_step"])
            # SDC quarantine attestations — every gang
            # member annotates the SAME verdict (the vote is
            # symmetric), so detection counts fold as a MAX across
            # members while injected-fault counts (which fired only on
            # the culprit) fold as written
            if hb.get("sdc_last_good"):
                self._sdc_resume = str(hb["sdc_last_good"])
            if hb.get("sdc_culprits"):
                self.summary.setdefault("sdc_culprits", sorted(
                    int(p) for p in hb["sdc_culprits"]))
            for kind, count in (hb.get("sdc_detected") or {}).items():
                sdc_detected[kind] = max(sdc_detected.get(kind, 0.0),
                                         float(count))
            for site, count in (hb.get("faults_injected")
                                or {}).items():
                sdc_injected[site] = sdc_injected.get(site, 0.0) \
                    + float(count)
        for kind, count in sdc_detected.items():
            _metrics.sdc_detected(kind).inc(count)
        for site, count in sdc_injected.items():
            _metrics.faults_injected(site).inc(count)

    def _tail(self, proc: subprocess.Popen, n: int = 2000) -> str:
        path = getattr(proc, "_znicz_log", None)
        if not path or not os.path.exists(path):
            return ""
        with open(path, errors="replace") as fh:
            return fh.read()[-n:]

    # -- the elastic loop -----------------------------------------------
    def run(self) -> dict:
        n = self.n_processes
        attempt = 0
        restarts = 0
        losses: dict[str, int] = {}
        resume_snapshots: list[str | None] = []
        while True:
            hb_dir = os.path.join(self.work_dir, f"hb_a{attempt}")
            os.makedirs(hb_dir, exist_ok=True)
            resume = self.initial_snapshot
            if attempt > 0:
                if self._sdc_resume:
                    # SDC restart: snapshots written AFTER the
                    # divergence may already carry the corruption —
                    # resume from the gang-attested PRE-divergence one
                    resume = self._sdc_resume
                    self._sdc_resume = None
                    self.summary["resumed"] = "pre-divergence"
                else:
                    resume = newest_good_snapshot(self.snapshot_dir,
                                                  self.snapshot_prefix)
            resume_snapshots.append(resume)
            self.monitor = HeartbeatMonitor(
                hb_dir, n, timeout_s=self.heartbeat_timeout_s,
                stall_timeout_s=self.stall_timeout_s,
                start_grace_s=self.start_grace_s)
            self.monitor.register_gauges()
            fed = None
            if _metrics.enabled():
                from znicz_tpu_torch.observe.federation import Federator
                fed = Federator("elastic")
                fed.add_heartbeats(hb_dir, n)
            procs = self._spawn(attempt, n, hb_dir, resume)
            dead: dict[int, str] = {}
            try:
                while True:
                    time.sleep(self.poll_interval_s)
                    if fed is not None:
                        fed.scrape()
                    rcs = [proc.poll() for proc in procs]
                    if all(rc == 0 for rc in rcs):
                        self.summary.update({
                            "attempts": attempt + 1,
                            "restarts": restarts, "losses": losses,
                            "final_processes": n,
                            "resume_snapshots": resume_snapshots,
                            "ok": True})
                        self.info("gang complete on attempt %d "
                                  "(%d process(es))", attempt, n)
                        return self.summary
                    for i, rc in enumerate(rcs):
                        if rc is not None and rc != 0 and i not in dead:
                            dead[i] = ("preempt" if rc == EXIT_PREEMPTED
                                       else "sdc" if rc == EXIT_SDC
                                       else "loss")
                            self.warning(
                                "worker %d exited rc=%d (%s)\n%s", i,
                                rc, dead[i], self._tail(procs[i]))
                    if any(k == "preempt" for k in dead.values()):
                        # the gang is draining through its own
                        # checkpoint barrier: give every member
                        # drain_s to land its fence + exit 75
                        deadline = time.time() + self.drain_s
                        while time.time() < deadline and any(
                                p.poll() is None for p in procs):
                            time.sleep(self.poll_interval_s)
                        for i, proc in enumerate(procs):
                            rc = proc.poll()
                            if rc == EXIT_PREEMPTED:
                                dead.setdefault(i, "preempt")
                            elif rc not in (None, 0):
                                dead.setdefault(i, "loss")
                        break
                    if dead:
                        # a hard loss strands every survivor inside the
                        # dead peer's collective — no point waiting for
                        # heartbeats to confirm what the exit code said
                        break
                    for i, kind in self.monitor.dead():
                        dead.setdefault(i, kind)
                    if dead:
                        break
                # 113-only observation: every exit seen so far is a
                # watchdog/SDC-peer victim — the ROOT CAUSE (a dead
                # host, or an EXIT_SDC culprit racing its peers to the
                # exit) may surface within a short settle window
                if dead and all(
                        k == "loss"
                        and procs[i].poll() == EXIT_PEER_LOST
                        for i, k in dead.items()):
                    deadline = time.time() + min(self.drain_s, 5.0)
                    while time.time() < deadline:
                        found_root = False
                        for i, proc in enumerate(procs):
                            rc = proc.poll()
                            if rc is not None and rc != 0 \
                                    and i not in dead:
                                dead[i] = (
                                    "preempt" if rc == EXIT_PREEMPTED
                                    else "sdc" if rc == EXIT_SDC
                                    else "loss")
                                if rc != EXIT_PEER_LOST:
                                    found_root = True
                        if found_root:
                            break
                        time.sleep(self.poll_interval_s)
                # a stall needs a settle window to tell culprit from
                # victim: the hung peer's watchdog exits it
                # EXIT_PEER_LOST while the seized host stays alive
                if any(k == "stall" for k in dead.values()):
                    settle = min(self.drain_s, max(
                        5.0, 1.5 * float(root.common.engine.get(
                            "collective_timeout_s") or 0)))
                    deadline = time.time() + settle
                    while time.time() < deadline and any(
                            procs[i].poll() is None for i in dead):
                        time.sleep(self.poll_interval_s)
            finally:
                self._fold_heartbeats(hb_dir, n)
                if fed is not None:
                    fed.scrape()  # the last fold before the dir goes cold
                    fed.close()
                self._kill(procs)
                self._close_logs(procs)
            # Only ROOT-CAUSE hosts are gone; everyone else rejoins:
            # - preempt: the flag names the requester — peers that
            #   drained through the barrier and exited 75 are healthy;
            # - stall: the culprit is the stalled process still ALIVE
            #   at the settle deadline (victims self-exited 113);
            # - loss: the dead children themselves, minus watchdog
            #   victims (rc EXIT_PEER_LOST follows a peer's death).
            preempted: set[int] = set()
            if any(k == "preempt" for k in dead.values()):
                flag = preempt_flag(hb_dir)
                preempted = {int(flag["requested_by"])} if flag else {
                    min(i for i, k in dead.items() if k == "preempt")}
            stalled = {i for i, k in dead.items() if k == "stall"}
            if len(stalled) > 1:
                alive_stalled = {i for i in stalled
                                 if procs[i].poll() in (None, -15, -9)}
                if alive_stalled and alive_stalled != stalled:
                    stalled = alive_stalled
            # an EXIT_SDC child is a sentinel-confirmed
            # corrupt chip — quarantined (blocklisted), never a victim
            sdc_hosts = {i for i, k in dead.items() if k == "sdc"}
            hard_lost = {i for i, k in dead.items()
                         if k == "loss"
                         and procs[i].poll() != EXIT_PEER_LOST} | stalled
            n_lost = max(1, len(hard_lost) + len(preempted)
                         + len(sdc_hosts))
            if not hard_lost and not preempted and not sdc_hosts:
                # every observed exit was a watchdog victim — the root
                # cause never even reached the channel; one host is
                # gone all the same
                losses["loss"] = losses.get("loss", 0) + 1
                _metrics.host_losses("loss").inc()
            for i in sorted(hard_lost):
                kind = dead.get(i, "loss")
                losses[kind] = losses.get(kind, 0) + 1
                _metrics.host_losses(kind).inc()
                _recorder.record("host_loss", process=i, cause=kind,
                                 attempt=attempt)
            for i in sorted(preempted):
                losses["preempt"] = losses.get("preempt", 0) + 1
                _metrics.host_losses("preempt").inc()
                _recorder.record("host_loss", process=i,
                                 cause="preempt", attempt=attempt)
            for i in sorted(sdc_hosts):
                losses["sdc"] = losses.get("sdc", 0) + 1
                self.blocklist.add(i)
                _metrics.host_losses("sdc").inc()
                _metrics.sdc_quarantined("host").inc()
                _recorder.record("sdc_quarantine", process=i,
                                 scope="host", attempt=attempt)
            if self.blocklist:
                self.summary["blocklisted"] = sorted(self.blocklist)
            survivors = n - n_lost
            if survivors < 1:
                # preemption of the LAST host: the checkpoint survives,
                # a later scheduling round resumes it — report, don't
                # spin
                self.summary.update({
                    "attempts": attempt + 1, "restarts": restarts,
                    "losses": losses, "final_processes": 0,
                    "resume_snapshots": resume_snapshots, "ok": False,
                    "reason": "no surviving hosts"})
                return self.summary
            if restarts >= self.max_restarts:
                raise RuntimeError(
                    f"elastic supervisor exceeded max_restarts="
                    f"{self.max_restarts} (losses={losses})")
            restarts += 1
            attempt += 1
            n = survivors
            _metrics.elastic_restarts().inc()
            _recorder.record("elastic_restart", attempt=attempt,
                             processes=n,
                             losses=",".join(
                                 f"{k}:{v}" for k, v in
                                 sorted(losses.items())))
            self.warning("restarting on the surviving mesh: %d → %d "
                         "process(es) (losses=%s)", n + n_lost, n,
                         losses)
