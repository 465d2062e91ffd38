"""The port's elastic supervision (``znicz_tpu_torch.resilience.supervisor``)
against the reference's, on the CPU: the cases of
``tests/test_supervisor.py``.

- the heartbeat writer and the coordinator's monitor (ok, starting,
  missing, stale, stalled; the age gauges), the preemption flag (first
  writer wins), the worker supervisor's barriered checkpoint on a
  signal (its file loading in the reference's snapshotter), a peer's
  flag joining the barrier, the hang watchdog, ``host.loss``'s process
  filter, ``checkpoint.signal_corrupt`` falling back to the older good
  snapshot, process 0 the only writer of a snapshot and of a published
  bundle while another process fences, SIGTERM routed to the
  preemption, ``newest_good_snapshot``;
- the gang supervisor on stub workers (a clean run, a lost host, a
  preemption, a stalled host), its summaries equal to the reference
  supervisor's on the same stub for the lost host.

Nothing here bounds a wall-clock time: a wait polls a file, a flag or an
exit until it holds (``_until``, whose limit only stops a hung test),
and the supervisors' own timeouts are set far past what a loaded
machine needs, except the stall bound, which is what the stall drill
measures.  The reference's ``/readyz`` case reads its web status page
(ROADMAP A13) and its ``jax.distributed`` bring-up cases are the
reference's own.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import pickle
import signal
import sys
import threading
import time

import numpy as np
import pytest

from znicz_tpu.resilience import supervisor as ref_sup
from znicz_tpu.utils.snapshotter import Snapshotter as RefSnapshotter
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.resilience import supervisor as sup
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _until(cond, limit_s: float = 120.0):
    """Poll ``cond`` until it holds (the limit only ends a hung test)."""
    deadline = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("the condition never held")
        time.sleep(0.01)


def _hb(directory, index=0) -> dict:
    with open(sup.heartbeat_path(str(directory), index)) as fh:
        return json.load(fh)


# ----------------------------------------------------------------------
# the heartbeat writer and the monitor
# ----------------------------------------------------------------------
def test_heartbeat_writer_beats_and_annotates(tmp_path):
    w = sup.HeartbeatWriter(str(tmp_path), 3, interval_s=0.05).start()
    try:
        w.beat(7)
        w.annotate(resumed_step=42)
        hb = _hb(tmp_path, 3)
        assert hb["process"] == 3 and hb["step"] == 7
        assert hb["resumed_step"] == 42 and hb["pid"] == os.getpid()
        # the thread refreshes the clock on its own, the step stays
        _until(lambda: _hb(tmp_path, 3)["time"] > hb["time"])
        assert _hb(tmp_path, 3)["step"] == 7
    finally:
        w.stop()
    assert sup.heartbeat_path(str(tmp_path), 3) == \
        ref_sup.heartbeat_path(str(tmp_path), 3)


def test_heartbeat_freeze_keeps_time_flowing(tmp_path):
    w = sup.HeartbeatWriter(str(tmp_path), 0, interval_s=0.05).start()
    try:
        w.beat(5)
        w.freeze()
        w.beat(9)  # frozen: the step does not move
        t0 = _hb(tmp_path)["time"]
        _until(lambda: _hb(tmp_path)["time"] > t0)
        assert _hb(tmp_path)["step"] == 5
    finally:
        w.stop()


@pytest.mark.parametrize("pkg", [ref_sup, sup])
def test_monitor_ok_stale_and_grace(tmp_path, pkg):
    mon = pkg.HeartbeatMonitor(str(tmp_path), 2, timeout_s=10.0,
                               start_grace_s=100.0)
    now = time.time()
    pkg._atomic_write_json(pkg.heartbeat_path(str(tmp_path), 0),
                           {"process": 0, "step": 3, "time": now})
    st = mon.poll(now=now)
    assert st[0]["status"] == "ok" and st[0]["step"] == 3
    assert st[1]["status"] == "starting"  # within the bring-up grace
    assert mon.dead(now=now) == []
    assert mon.poll(now=now + 200.0)[1]["status"] == "missing"
    assert mon.poll(now=now + 200.0)[0]["status"] == "stale"
    assert set(mon.dead(now=now + 200.0)) == {(0, "loss"), (1, "loss")}


@pytest.mark.parametrize("pkg", [ref_sup, sup])
def test_monitor_detects_stalled_step_counter(tmp_path, pkg):
    mon = pkg.HeartbeatMonitor(str(tmp_path), 1, timeout_s=60.0,
                               stall_timeout_s=3.0)
    t0 = time.time()
    path = pkg.heartbeat_path(str(tmp_path), 0)
    pkg._atomic_write_json(path, {"process": 0, "step": 5, "time": t0})
    assert mon.poll(now=t0)[0]["status"] == "ok"
    pkg._atomic_write_json(path, {"process": 0, "step": 5,
                                  "time": t0 + 5.0})
    st = mon.poll(now=t0 + 5.0)
    assert st[0]["status"] == "stalled"
    assert st[0]["step_age_s"] == pytest.approx(5.0)
    assert mon.dead(now=t0 + 5.0) == [(0, "stall")]
    pkg._atomic_write_json(path, {"process": 0, "step": 6,
                                  "time": t0 + 6.0})
    assert mon.poll(now=t0 + 6.0)[0]["status"] == "ok"


def test_monitor_gauges_feed_the_series(tmp_path):
    mon = sup.HeartbeatMonitor(str(tmp_path), 2, timeout_s=5.0)
    mon.register_gauges()
    sup._atomic_write_json(sup.heartbeat_path(str(tmp_path), 0),
                           {"process": 0, "step": 1,
                            "time": time.time() - 2.5})
    assert metrics.heartbeat_age_seconds(0).value >= 2.5
    assert metrics.heartbeat_age_seconds(1).value == float("inf")
    assert "znicz_heartbeat_age_seconds" in metrics.REGISTRY.to_prometheus()


# ----------------------------------------------------------------------
# preemption: the flag, the barrier, the checkpoint on a signal
# ----------------------------------------------------------------------
class _StubWorkflow:
    """The part of a workflow the worker supervisor touches."""

    name = "stub_wf"
    snapshotter = None
    loader = None

    def __init__(self):
        self._step_hooks = []
        self.stopped_calls = 0
        self.state = {"__units__": {"u": {"w": [1.0, 2.0]}}}

    def add_step_hook(self, fn):
        self._step_hooks.append(fn)

    def remove_step_hook(self, fn):
        self._step_hooks.remove(fn)

    def on_step_boundary(self):
        for fn in list(self._step_hooks):
            fn()

    def state_dict(self, allow_collective=False):
        assert allow_collective, "the checkpoint gathers in lockstep"
        return self.state

    def stop(self):
        self.stopped_calls += 1


class _StubSnapshotter:
    def __init__(self, directory):
        self.directory = str(directory)
        self.prefix = "stub"


@pytest.mark.parametrize("pkg", [ref_sup, sup])
def test_preempt_flag_first_writer_wins(tmp_path, pkg):
    pkg.request_preempt_flag(str(tmp_path), 12, 1, "first")
    pkg.request_preempt_flag(str(tmp_path), 99, 0, "second")
    flag = pkg.preempt_flag(str(tmp_path))
    assert flag["barrier_step"] == 12 and flag["requested_by"] == 1


def test_worker_supervisor_checkpoint_on_signal(tmp_path):
    wf = _StubWorkflow()
    wf.snapshotter = _StubSnapshotter(tmp_path / "snaps")
    supv = sup.WorkerSupervisor(
        wf, directory=str(tmp_path / "hb"), process_index=0,
        process_count=1, heartbeat_interval_s=0.05).attach()
    before = metrics.checkpoint_on_signal().value
    wf.on_step_boundary()
    wf.on_step_boundary()
    assert supv.step == 2
    supv.request_preempt("SIGTERM test")  # the barrier is step + 1
    with pytest.raises(sup.Preempted) as err:
        wf.on_step_boundary()
    assert err.value.code == sup.EXIT_PREEMPTED == ref_sup.EXIT_PREEMPTED
    path = err.value.snapshot_path
    assert path.endswith("preempt_s3.pickle.gz") and os.path.exists(path)
    digest = open(path + ".sha256").read().strip()
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest
    assert pickle.load(gzip.open(path, "rb")) == wf.state
    assert RefSnapshotter.load(path) == wf.state  # the reference reads it
    assert wf.stopped_calls == 1
    assert metrics.checkpoint_on_signal().value == before + 1
    hb = _hb(tmp_path / "hb")
    assert hb["checkpoint_on_signal"] == 1 and hb["checkpoint_path"] == path
    supv.detach()


def test_worker_supervisor_peer_flag_joins_barrier(tmp_path):
    """A process that never saw the signal reads the flag at its next
    step boundary and checkpoints at the same barrier step."""
    wf = _StubWorkflow()
    wf.snapshotter = _StubSnapshotter(tmp_path / "snaps")
    supv = sup.WorkerSupervisor(
        wf, directory=str(tmp_path), process_index=0, process_count=1,
        heartbeat_interval_s=0.05).attach()
    wf.on_step_boundary()
    ref_sup.request_preempt_flag(str(tmp_path), 3, 1, "peer signal")
    wf.on_step_boundary()  # step 2 < the barrier: trains on
    with pytest.raises(sup.Preempted):
        wf.on_step_boundary()  # step 3, the barrier: the checkpoint
    assert supv.step == 3
    supv.detach()


def test_watchdog_surfaces_peer_lost(tmp_path, monkeypatch):
    """A step boundary that never comes (a peer gone mid-collective)
    makes the watchdog exit ``EXIT_PEER_LOST``, not before the first
    boundary (bring-up is unbounded)."""
    exits = []
    monkeypatch.setattr(sup.os, "_exit", lambda rc: exits.append(rc))
    wf = _StubWorkflow()
    supv = sup.WorkerSupervisor(
        wf, directory=str(tmp_path), process_index=0, process_count=2,
        heartbeat_interval_s=0.05, collective_timeout_s=0.3).attach()
    time.sleep(0.6)
    assert exits == [], "the watchdog fired during bring-up (step 0)"
    wf.on_step_boundary()  # the first boundary arms the bound
    _until(lambda: exits)
    assert exits[0] == sup.EXIT_PEER_LOST == ref_sup.EXIT_PEER_LOST
    assert _hb(tmp_path).get("peer_lost") is True
    supv.detach()


def test_host_loss_site_respects_process_filter():
    plan = faults.FaultPlan({"host.loss": {"process": 1, "at": [2]}})
    assert plan.fire("host.loss", process=0) is None
    assert plan.fire("host.loss", process=1) is None   # arrival 1
    payload = plan.fire("host.loss", process=1)        # arrival 2
    assert payload is not None and payload["arrival"] == 2
    assert plan.fire("host.loss", process=0) is None


def test_checkpoint_signal_corrupt_falls_back(tmp_path):
    """The corrupted checkpoint fails its digest: the newest-good picker
    skips it and the loader falls back to the older good snapshot, in
    both packages."""
    wf = _StubWorkflow()
    snaps = tmp_path / "snaps"
    wf.snapshotter = _StubSnapshotter(snaps)
    good = Snapshotter.write({"good": True}, str(snaps), "stub", "e1")
    os.utime(good, (1000, 1000))
    root.common.engine.faults = {"checkpoint.signal_corrupt": True}
    supv = sup.WorkerSupervisor(wf, directory=str(tmp_path / "hb"),
                                process_index=0, process_count=1).attach()
    wf.on_step_boundary()
    supv.request_preempt("preempt with corruption")
    with pytest.raises(sup.Preempted) as err:
        wf.on_step_boundary()
    bad = err.value.snapshot_path
    assert sup.newest_good_snapshot(str(snaps), "stub") == good == \
        ref_sup.newest_good_snapshot(str(snaps), "stub")
    assert Snapshotter.load(bad) == {"good": True} == RefSnapshotter.load(bad)
    supv.detach()


# ----------------------------------------------------------------------
# process 0 the only writer, the others fencing
# ----------------------------------------------------------------------
def _patch_process_info(monkeypatch, local):
    """``(index, count)`` by thread, so one test process plays both
    members of a gang."""
    from znicz_tpu_torch.parallel import distributed, process_shard

    def fake_process_info():
        return getattr(local, "info", (0, 1))

    monkeypatch.setattr(process_shard, "process_info", fake_process_info)
    monkeypatch.setattr(distributed, "process_info", fake_process_info)


def test_snapshot_write_single_writer_under_two_processes(
        tmp_path, monkeypatch):
    """Two members calling ``Snapshotter.write`` give exactly one
    complete file: process 1 waits on the sidecar and writes nothing."""
    local = threading.local()
    _patch_process_info(monkeypatch, local)
    root.common.engine.snapshot_fence_timeout_s = 300.0
    state = {"w": list(range(1000))}
    results = {}

    def nonmaster():
        local.info = (1, 2)
        results["path1"] = Snapshotter.write(state, str(tmp_path), "gang",
                                             "e1")

    fencer = threading.Thread(target=nonmaster)
    fencer.start()
    time.sleep(0.2)
    assert fencer.is_alive(), "the other process wrote without a fence"
    local.info = (0, 2)
    path0 = Snapshotter.write(state, str(tmp_path), "gang", "e1")
    fencer.join(300)
    assert results["path1"] == path0
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pickle.gz")]
    assert files == ["gang_e1.pickle.gz"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert Snapshotter.load(path0) == state == RefSnapshotter.load(path0)


def test_snapshot_fence_times_out_with_an_error(tmp_path, monkeypatch):
    local = threading.local()
    _patch_process_info(monkeypatch, local)
    local.info = (1, 2)
    root.common.engine.snapshot_fence_timeout_s = 0.2
    with pytest.raises(OSError, match="fence"):
        Snapshotter.write({}, str(tmp_path), "gang", "never")


def test_publish_bundle_single_writer_under_two_processes(
        tmp_path, monkeypatch):
    from znicz_tpu_torch import export as export_mod
    from znicz_tpu_torch.resilience import publisher as pub
    local = threading.local()
    _patch_process_info(monkeypatch, local)
    writes = []
    real_write = export_mod._write_bundle

    def fake_export(workflow, path, extra=None):
        real_write(path, {"workflow": str(workflow), **(extra or {})},
                   {"layer0_weights": np.zeros(3, np.float32)})
        writes.append(path)

    monkeypatch.setattr(export_mod, "export_forward", fake_export)
    results = {}

    def nonmaster():
        local.info = (1, 2)
        results["fence"] = pub.publish_bundle("wf", str(tmp_path),
                                              prefix="m")

    fencer = threading.Thread(target=nonmaster)
    fencer.start()
    local.info = (0, 2)
    version, path = pub.publish_bundle("wf", str(tmp_path), prefix="m")
    fencer.join(300)
    assert (version, path) == results["fence"] == (
        1, os.path.join(str(tmp_path), "m_v000001.npz"))
    assert len(writes) == 1, "the other process exported a bundle"
    digest = open(path + ".sha256").read().strip()
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest


def test_launcher_sigterm_routes_to_preempt_not_emergency():
    """With a worker supervisor attached, SIGTERM asks for the barriered
    checkpoint (at the next step boundary) instead of the emergency
    snapshot; a second signal still interrupts at once."""
    from znicz_tpu_torch.launcher import Launcher
    launcher = Launcher(backend="numpy")
    preempts = []

    class StubSup:
        def request_preempt(self, reason):
            preempts.append(reason)

    class StubWf:
        name = "stub"

        def __init__(self):
            self.stops = 0

        def stop(self):
            self.stops += 1

    wf = StubWf()
    launcher._worker_supervisor = StubSup()
    launcher._install_signal_handlers(wf)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        _until(lambda: preempts)
        assert preempts == [f"signal {int(signal.SIGTERM)}"]
        assert wf.stops == 0, "the emergency stop ran too"
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
            _until(lambda: False)
    finally:
        launcher._restore_signal_handlers()


def test_newest_good_snapshot_skips_corrupt(tmp_path):
    a = Snapshotter.write({"v": 1}, str(tmp_path), "s", "a")
    os.utime(a, (1000, 1000))
    b = Snapshotter.write({"v": 2}, str(tmp_path), "s", "b")
    assert sup.newest_good_snapshot(str(tmp_path), "s") == b
    with open(b, "r+b") as fh:  # the newest corrupted after its digest
        fh.write(b"XXXX")
    assert sup.newest_good_snapshot(str(tmp_path), "s") == a == \
        ref_sup.newest_good_snapshot(str(tmp_path), "s")


# ----------------------------------------------------------------------
# the gang supervisor on stub workers
# ----------------------------------------------------------------------
#: a stub gang member: it beats 6 steps; ``die`` kills process 1 at step
#: 3, ``preempt`` drains both through a barrier at step 4 (exit 75),
#: ``stall`` freezes process 1 at step 3 (its clock still beating) while
#: process 0 goes on stepping until the supervisor stops the gang
_STUB = """\
import os, sys, time
sys.path.insert(0, {repo!r})
from {package}.resilience import supervisor as sup
pid = int(os.environ["ZNICZ_PROCESS_ID"])
attempt = int(os.environ["ZNICZ_ELASTIC_ATTEMPT"])
hb_dir = os.environ["ZNICZ_HEARTBEAT_DIR"]
mode = os.environ.get("STUB_MODE", "ok")
w = sup.HeartbeatWriter(hb_dir, pid, interval_s=0.05).start()
w.annotate(resumed_step=7 if attempt else 0)
for step in range(1, 7):
    w.beat(step)
    if mode == "die" and pid == 1 and step == 3:
        os._exit(1)
    if mode == "preempt" and step == 3:
        sup.request_preempt_flag(hb_dir, step + 1, 1, "stub preempt")
        w.annotate(checkpoint_on_signal=1)
        w.stop()
        os._exit(sup.EXIT_PREEMPTED)
    if mode == "stall" and pid == 1 and step == 3:
        w.freeze()
        while True:
            time.sleep(1)
    if mode == "stall" and pid == 0 and step == 6:
        while True:  # healthy: its step moves until the gang is stopped
            step += 1
            w.beat(step)
            time.sleep(0.05)
w.stop()
"""


def _stub_supervisor(tmp_path, mode, package="znicz_tpu_torch", **kwargs):
    stub = tmp_path / f"stub_{package}.py"
    stub.write_text(_STUB.format(repo=REPO, package=package))
    module = sup if package == "znicz_tpu_torch" else ref_sup
    defaults = dict(
        n_processes=2, work_dir=str(tmp_path / f"work_{package}"),
        snapshot_dir=str(tmp_path / "snaps"), heartbeat_timeout_s=600.0,
        stall_timeout_s=600.0, start_grace_s=600.0, poll_interval_s=0.05,
        drain_s=600.0, max_restarts=2, fault_env={"STUB_MODE": mode})
    defaults.update(kwargs)
    return module.ElasticSupervisor(
        lambda pid, n, attempt: [sys.executable, str(stub)], **defaults)


def test_gang_clean_run_no_restarts(tmp_path):
    summary = _stub_supervisor(tmp_path, "ok").run()
    assert summary["ok"] and summary["restarts"] == 0
    assert summary["losses"] == {} and summary["final_processes"] == 2


def test_gang_host_loss_restarts_on_survivors(tmp_path):
    """A dead member: the restart on the survivor, whose resume position
    the supervisor folds from the channel; the reference's supervisor
    over the same stub sums it up alike."""
    before = metrics.host_losses("loss").value
    restarts = metrics.elastic_restarts().value
    summary = _stub_supervisor(tmp_path, "die").run()
    assert summary["ok"] and summary["restarts"] == 1
    assert summary["losses"] == {"loss": 1}
    assert summary["final_processes"] == 1
    assert summary["resumed_step"] == 7
    assert metrics.host_losses("loss").value == before + 1
    assert metrics.elastic_restarts().value == restarts + 1
    ref = _stub_supervisor(tmp_path, "die", package="znicz_tpu").run()
    assert {k: v for k, v in summary.items() if k != "resume_snapshots"} \
        == {k: v for k, v in ref.items() if k != "resume_snapshots"}


def test_gang_preemption_only_requester_is_lost(tmp_path):
    """Both members drain through the barrier and exit 75; only the
    requester's host is gone, the drained peer rejoins."""
    before = metrics.host_losses("preempt").value
    cps = metrics.checkpoint_on_signal().value
    summary = _stub_supervisor(tmp_path, "preempt").run()
    assert summary["ok"] and summary["restarts"] == 1
    assert summary["losses"] == {"preempt": 1}
    assert summary["final_processes"] == 1
    assert metrics.host_losses("preempt").value == before + 1
    assert metrics.checkpoint_on_signal().value == cps + 2


def test_gang_stall_culprit_detected_victim_rejoins(tmp_path):
    """A member whose step freezes while its clock beats is declared
    stalled and killed; its healthy peer rejoins.  The stall bound (10 s)
    is what the drill measures, far past a loaded machine's gap between
    a healthy stub's last beat and its exit."""
    before = metrics.host_losses("stall").value
    summary = _stub_supervisor(tmp_path, "stall", stall_timeout_s=10.0,
                               drain_s=5.0).run()
    assert summary["ok"] and summary["restarts"] == 1
    assert summary["losses"] == {"stall": 1}
    assert summary["final_processes"] == 1
    assert metrics.host_losses("stall").value == before + 1
