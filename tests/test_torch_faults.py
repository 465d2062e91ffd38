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
  item that owns its module, and no call names an unknown site;
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
#: item that owns each (ROADMAP.md, queue A)
UNFIRED = {
    "train.nonfinite_loss": "A11", "train.nonfinite_grad": "A11",
    "sdc.flip_param": "A11", "sdc.flip_grad": "A11",
    "publish.corrupt": "A11", "swap.canary_regress": "A11",
    "swap.probation_fail": "A11", "host.loss": "A11",
    "host.preempt": "A11", "heartbeat.stall": "A11",
    "checkpoint.signal_corrupt": "A11",
    "loader.reader_death": "A10", "loader.corrupt_shard": "A10",
    "loader.short_read": "A10",
    "fleet.tenant_flood": "A12", "fleet.replica_loss": "A12",
    "disagg.handoff_drop": "A12", "aotcache.corrupt": "A12",
    "fleet.model_corrupt": "A13",
}


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
        "serving.program_error": {"engine.py"},
        "serving.latency_spike": {"engine.py"},
        "sdc.serving_bitflip": {"engine.py"},
        "snapshot.write_fail": {"snapshotter.py"},
        "quant.calib_corrupt": {"quantize.py"},
        "observe.recorder_stall": {"recorder.py"}}
    assert set(UNFIRED.values()) <= {"A10", "A11", "A12", "A13"}


@pytest.mark.parametrize("site", sorted(faults.SITES))
def test_every_site_accepts_a_one_event_recipe(site):
    plan = faults.FaultPlan({site: {"at": [1]}})
    assert plan.configured_sites() == {site}
    assert len(faults.SITES[site]) > 30


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
