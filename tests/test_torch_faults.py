"""The port's fault injection (``znicz_tpu_torch.resilience.faults``)
against the reference's, on the CPU.

- the six fault-plan tests of ``tests/test_resilience.py`` through both
  packages' ``FaultPlan`` with the same recipes: the same fire
  sequences arrival by arrival (the ``p`` stream too: both draw from a
  Philox stream keyed by ``(seed, crc32(site))``), the same payloads,
  the same event counts and the same refusals;
- ``SITES`` equal to the reference's, name for name and text for text;
- the chaos-matrix pins of ``tests/test_chaos_matrix.py`` for the port:
  every site whose module is ported has a live ``fire("<site>"`` call
  in ``znicz_tpu_torch/``, every other site is listed with the ROADMAP
  item that owns its module, and no call names an unknown site; the
  streaming loader's three sites fire live and are absorbed, and so do
  the eleven resilience sites (the guard's, the publisher's and the
  supervisor's), each in one small drill;
- ``snapshot.write_fail`` is absorbed: training goes on, the failure is
  counted, and ``destination`` keeps the last good snapshot, which
  loads (the port of
  ``test_snapshot_write_failure_tolerated_keeps_last_good``).
"""

import os
import pathlib
import re

import numpy as np
import pytest
import torch

from conftest import make_blobs
from znicz_tpu.resilience import faults as ref_faults
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

PKG = pathlib.Path(__file__).resolve().parent.parent / "znicz_tpu_torch"

#: the sites whose modules the port has not ported yet, by the ROADMAP
#: item that owns each (ROADMAP.md, queue A): none is left
UNFIRED: dict[str, str] = {}


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _both(recipe, **kwargs):
    return (ref_faults.FaultPlan(dict(recipe), **kwargs),
            faults.FaultPlan(dict(recipe), **kwargs))


def _fires(plan, site, n, **ctx):
    return [plan.fire(site, **ctx) is not None for _ in range(n)]


def test_fault_plan_at_list_fires_exact_arrivals():
    for plan in _both({"serving.program_error": [2, 4]}):
        assert _fires(plan, "serving.program_error", 6) == \
            [False, True, False, True, False, False]
        assert plan.events_fired == 2


def test_fault_plan_persistent_after_counts_one_event():
    for plan in _both({"loader.corrupt_shard": {"after": 2}}):
        assert _fires(plan, "loader.corrupt_shard", 5) == \
            [False, True, True, True, True]
        assert plan.events_fired == 1  # one corrupt shard, many reads


def test_fault_plan_context_filter_and_payload():
    payloads = []
    for plan in _both({"loader.corrupt_shard": {"shard": 1, "after": 1}}):
        assert plan.fire("loader.corrupt_shard", shard=0) is None
        payload = plan.fire("loader.corrupt_shard", shard=1)
        assert payload is not None and payload["shard"] == 1
        assert payload["site"] == "loader.corrupt_shard"
        # mismatched arrivals did not consume the counter
        assert plan.fire("loader.corrupt_shard", shard=2) is None
        assert plan.fire("loader.corrupt_shard", shard=1) is not None
        payloads.append(payload)
    assert payloads[0] == payloads[1]


@pytest.mark.parametrize("seed,p", [(9, 0.3), (0, 0.05), (123, 0.5)])
def test_fault_plan_probabilistic_is_seed_deterministic(seed, p):
    recipe = {"_seed": seed, "serving.latency_spike": {"p": p},
              "serving.program_error": {"p": p}}
    ref, port = _both(recipe)
    for site in ("serving.latency_spike", "serving.program_error"):
        want = _fires(ref, site, 256)
        assert _fires(port, site, 256) == want
        assert any(want) and not all(want)
    assert port.counts() == ref.counts()
    again = faults.FaultPlan(dict(recipe))
    assert _fires(again, "serving.latency_spike", 256) == \
        _fires(ref_faults.FaultPlan(dict(recipe)),
               "serving.latency_spike", 256)


def test_fault_plan_rejects_unknown_site_and_bad_spec():
    for module in (ref_faults, faults):
        with pytest.raises(ValueError, match="unknown fault site"):
            module.FaultPlan({"train.typo_site": 1})
        with pytest.raises(ValueError, match="needs one of"):
            module.FaultPlan({"train.nonfinite_loss": {"shard": 3}})


def test_faults_off_is_none():
    assert faults.active() is None
    assert faults.fire("train.nonfinite_loss") is None
    root.common.engine.faults = {"serving.program_error": {"at": [1]}}
    plan = faults.active()
    assert isinstance(plan, faults.FaultPlan)  # wrapped once, then kept
    assert faults.active() is plan
    assert faults.site_configured("serving.program_error")
    assert not faults.site_configured("snapshot.write_fail")
    injected = metrics.faults_injected("serving.program_error").value
    assert faults.fire("serving.program_error") is not None
    assert faults.fire("serving.program_error") is None
    assert metrics.faults_injected("serving.program_error").value == \
        injected + 1


def test_sites_equal_the_reference():
    assert faults.SITES == ref_faults.SITES
    assert faults.SITES is not ref_faults.SITES


# ----------------------------------------------------------------------
# the chaos-matrix pins, for the port
# ----------------------------------------------------------------------
def _fired_in_port() -> dict[str, set]:
    pattern = re.compile(r"""fire\(\s*['"]([a-z_.]+)['"]""")
    fired: dict[str, set] = {}
    for path in PKG.rglob("*.py"):
        if path.name == "faults.py":
            continue  # its docstring's example is not an injection point
        for site in pattern.findall(path.read_text()):
            fired.setdefault(site, set()).add(path.name)
    return fired


def test_every_ported_site_has_a_live_fire_call():
    fired = _fired_in_port()
    unknown = sorted(set(fired) - set(faults.SITES))
    assert not unknown, f"fire() call sites not declared in SITES: {unknown}"
    assert set(UNFIRED) <= set(faults.SITES)
    assert sorted(fired) == sorted(set(faults.SITES) - set(UNFIRED)), (
        f"fired {sorted(fired)}; unfired {sorted(UNFIRED)}")
    assert fired == {
        "serving.program_error": {"engine.py", "decode.py"},
        "serving.latency_spike": {"engine.py", "decode.py"},
        "sdc.serving_bitflip": {"engine.py"},
        "snapshot.write_fail": {"snapshotter.py"},
        "quant.calib_corrupt": {"quantize.py"},
        "observe.recorder_stall": {"recorder.py"},
        "loader.reader_death": {"streaming.py"},
        "loader.corrupt_shard": {"streaming.py"},
        "loader.short_read": {"streaming.py"},
        "train.nonfinite_loss": {"guard.py"},
        "train.nonfinite_grad": {"guard.py"},
        "sdc.flip_param": {"guard.py"},
        "sdc.flip_grad": {"guard.py"},
        "publish.corrupt": {"publisher.py"},
        "swap.canary_regress": {"publisher.py"},
        "swap.probation_fail": {"publisher.py"},
        "host.loss": {"supervisor.py"},
        "host.preempt": {"supervisor.py"},
        "heartbeat.stall": {"supervisor.py"},
        "checkpoint.signal_corrupt": {"supervisor.py"},
        "fleet.tenant_flood": {"fleet.py"},
        "fleet.replica_loss": {"fleet.py"},
        "aotcache.corrupt": {"aot_cache.py"},
        "disagg.handoff_drop": {"disagg.py"},
        "fleet.model_corrupt": {"forge.py"}}
    assert set(UNFIRED.values()) <= {"A13"}


@pytest.mark.parametrize("site", sorted(faults.SITES))
def test_every_site_accepts_a_one_event_recipe(site):
    plan = faults.FaultPlan({site: {"at": [1]}})
    assert plan.configured_sites() == {site}
    assert len(faults.SITES[site]) > 30


@pytest.mark.parametrize("site", ["loader.reader_death",
                                  "loader.corrupt_shard",
                                  "loader.short_read"])
def test_loader_sites_fire_live(site, tmp_path):
    """Each of the streaming loader's sites fires on its first arrival
    in a live pipeline and is absorbed: the steps go on."""
    from znicz_tpu_torch.loader.streaming import (StreamingLoader,
                                                  write_shards)
    from znicz_tpu_torch.workflow import Workflow
    data, labels = make_blobs(24, 3, 10, spread=1.2)
    write_shards(str(tmp_path / "s"), data, labels, rows_per_shard=20)
    root.common.engine.read_backoff_s = 0.0
    root.common.engine.faults = {site: {"at": [1]}}
    injected = metrics.faults_injected(site).value
    prng.seed_all(5)
    loader = StreamingLoader(Workflow(name="w"), str(tmp_path / "s"),
                             minibatch_size=12)
    loader.initialize(device="cpu")
    try:
        for _ in range(3):
            loader.run()
    finally:
        loader.stop()
    assert metrics.faults_injected(site).value == injected + 1
    assert loader.pipeline_restarts == (site == "loader.reader_death")


# ----------------------------------------------------------------------
# snapshot.write_fail
# ----------------------------------------------------------------------
def test_snapshot_write_failure_tolerated_keeps_last_good(tmp_path):
    """The second snapshot write fails mid-stream: the unit counts it,
    keeps ``destination`` on the first file, and training goes on."""
    root.common.engine.faults = {"snapshot.write_fail": {"at": [2]}}
    data, labels = make_blobs(24, 3, 10, spread=1.2)
    prng.seed_all(5)
    wf = StandardWorkflow(
        name="snap_tol",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
                 "<-": {"learning_rate": 0.01}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.01}}],
        decision_config={"max_epochs": 6},
        snapshotter_config={"prefix": "snap_tol", "keep_last": 0,
                            "directory": str(tmp_path)})
    wf.initialize(device="cpu")
    written = []
    write = Snapshotter.write

    def recording_write(*args):
        try:
            path = write(*args)
        except OSError:
            written.append(None)
            raise
        written.append(path)
        return path

    wf.snapshotter.write = recording_write
    fails = metrics.snapshot_failures("write").value
    recovered = metrics.recoveries("snapshot_write").value
    injected = metrics.faults_injected("snapshot.write_fail").value
    wf.run()  # the second improved epoch's write fails; the run goes on
    assert len(written) >= 3 and written[1] is None, written
    assert metrics.snapshot_failures("write").value == fails + 1
    assert metrics.recoveries("snapshot_write").value == recovered + 1
    assert metrics.faults_injected("snapshot.write_fail").value == \
        injected + 1
    dest = wf.snapshotter.destination
    assert dest == written[-1] and os.path.exists(dest)
    assert os.path.exists(written[0])
    Snapshotter.load(dest)  # the surviving destination verifies
    # no half-written tmp litter, and no file of the failed write
    names = os.listdir(tmp_path)
    assert not [f for f in names if f.endswith(".tmp")]
    assert len([f for f in names if f.endswith(".pickle.gz")]) == \
        len(written) - 1
    state = Snapshotter.load(written[0])
    assert isinstance(state, dict) and np.isfinite(
        wf.decision.min_validation_n_err_pt)


# ----------------------------------------------------------------------
# the resilience sites, each fired live
# ----------------------------------------------------------------------
def _mlp(name, snap_dir=None, max_epochs=1):
    data, labels = make_blobs(24, 3, 10, spread=1.2)
    prng.seed_all(5)
    wf = StandardWorkflow(
        name=name,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                {"type": "softmax", "->": {"output_sample_shape": 3},
                 "<-": {"learning_rate": 0.05}}],
        decision_config={"max_epochs": max_epochs},
        snapshotter_config=(None if snap_dir is None else
                            {"prefix": name, "directory": snap_dir}))
    wf.initialize(device="cpu")
    return wf


class _Engine:
    """The part of a serving engine the swap controller drives."""

    def __init__(self, bundle):
        self.bundle, self.model_version = bundle, 0
        self.outcomes, self.served = [], 0

    def current_bundle(self):
        return self.bundle

    def swap_weights(self, state, *, version=None, outcome="promoted"):
        self.bundle, self.model_version = state, version
        self.outcomes.append(outcome)

    def record_swap_outcome(self, outcome):
        self.outcomes.append(outcome)

    def stats(self):
        return {"served": self.served}

    def ready(self):
        return True


def _fire_guard_site(site, tmp_path):
    wf = _mlp(site)
    wf.run()
    state = wf.anomaly_guard.read_state()
    if site == "train.nonfinite_loss":
        assert state == (0, 1, 0)
    elif site == "train.nonfinite_grad":
        assert state == (0, 0, 1)
    elif site == "sdc.flip_param":
        assert wf.anomaly_guard.read_sdc_fingerprint()[3] == 1.0
    else:
        root.common.engine.faults = None
        clean = _mlp("clean")
        clean.run()
        assert not torch.equal(wf.forwards[0].weights,
                               clean.forwards[0].weights)


def _fire_publisher_site(site, tmp_path):
    from znicz_tpu_torch.export import read_bundle
    from znicz_tpu_torch.resilience.publisher import (PublicationWatcher,
                                                      SwapController,
                                                      publish_bundle)
    plan = root.common.engine.faults
    root.common.engine.faults = None
    wf = _mlp("publish")
    wf.run()
    pub = str(tmp_path / "pub")
    _, path = publish_bundle(wf, pub)
    if site == "publish.corrupt":
        root.common.engine.faults = plan
        publish_bundle(wf, pub)
        watcher = PublicationWatcher(pub)
        assert watcher.poll()[0] == 1  # v2 refused, v1 the fallback
        assert 2 in watcher._bad
        return
    engine = _Engine(read_bundle(path))
    watcher = PublicationWatcher(pub)
    ctl = SwapController(engine, watcher,
                         score_fn=lambda manifest, params: 1.0,
                         guard_margin=0.0, probation_steps=5)
    root.common.engine.faults = plan
    events = ctl.tick()
    if site == "swap.canary_regress":
        assert events[0].startswith("rejected v1") \
            and engine.outcomes == ["rejected"]
    else:
        events += ctl.tick()
        assert engine.outcomes == ["promoted", "rolled_back"] \
            and events[-1].startswith("rolled back v1")


_WORKER = """\
import os, sys
sys.path.insert(0, {repo!r})
from znicz_tpu_torch.resilience import supervisor as sup
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.workflow import Workflow
root.common.engine.faults = {{"host.loss": {{"at": [2]}}}}
s = sup.WorkerSupervisor(Workflow(name="w"), process_index=0,
                         process_count=1).attach()
for _ in range(3):
    s.on_step()
print("survived")
"""


def _fire_supervisor_site(site, tmp_path):
    import subprocess
    import sys

    from znicz_tpu_torch.resilience import supervisor as sup
    from znicz_tpu_torch.workflow import Workflow
    if site == "host.loss":
        script = tmp_path / "worker.py"
        script.write_text(_WORKER.format(repo=str(PKG.parent)))
        root.common.engine.faults = None
        done = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=300)
        assert done.returncode == 1 and "survived" not in done.stdout
        root.common.engine.faults = {site: {"at": [1]}}
        assert faults.fire(site) is not None  # the plan this process holds
        return
    if site == "checkpoint.signal_corrupt":
        wf = _mlp("ckpt", snap_dir=str(tmp_path / "snaps"))
        s = sup.WorkerSupervisor(wf, process_index=0, process_count=1)
        s.request_preempt("test")
        with pytest.raises(sup.Preempted) as exc:
            s.checkpoint_on_signal()
        with pytest.raises(Exception):
            Snapshotter._load_verified(exc.value.snapshot_path)
        return
    hb = str(tmp_path / "hb")
    s = sup.WorkerSupervisor(Workflow(name="w"), directory=hb,
                             process_index=0, process_count=1).attach()
    try:
        if site == "heartbeat.stall":
            root.common.engine.faults = {site: {"at": [1], "sleep_s": 0.0}}
        s.on_step()  # the barrier of a preemption is the next step
        if site == "host.preempt":
            assert sup.preempt_flag(hb)["barrier_step"] == 2
        else:
            s.on_step()
            assert s.writer.step == 1  # frozen at the stall
    finally:
        s.detach()


@pytest.mark.parametrize("site", [
    "train.nonfinite_loss", "train.nonfinite_grad", "sdc.flip_param",
    "sdc.flip_grad", "publish.corrupt", "swap.canary_regress",
    "swap.probation_fail", "host.loss", "host.preempt", "heartbeat.stall",
    "checkpoint.signal_corrupt"])
def test_resilience_site_fires_live(site, tmp_path):
    """Each resilience site fires once in a small live drill and has its
    effect: a skipped and counted step, the sticky self-check, a changed
    update, a bundle the watcher refuses, a canary rejection, a
    probation rollback, a process that dies, a preemption barrier, a
    frozen heartbeat, a checkpoint whose digest no longer checks."""
    # a flip before the first train step has no claimed value to differ
    # from: the drill flips before the second
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    root.common.engine.faults = {
        site: {"at": [2 if site == "sdc.flip_param" else 1]}}
    injected = metrics.faults_injected(site).value
    if site.startswith(("train.", "sdc.")):
        _fire_guard_site(site, tmp_path)
    elif site.startswith(("publish.", "swap.")):
        _fire_publisher_site(site, tmp_path)
    else:
        _fire_supervisor_site(site, tmp_path)
    assert metrics.faults_injected(site).value == injected + 1
