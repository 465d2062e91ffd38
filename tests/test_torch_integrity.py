"""The port's SDC sentinel (``znicz_tpu_torch.resilience.integrity``)
against the reference's, on the CPU: the cases of
``tests/test_integrity.py``, each through both packages side by side.

- the fingerprint algebra: the port's numpy fold bit-equal to the
  reference's, its device fold (``fingerprint_partial``) within 1e-6
  relative (torch adds the ~64 products in another order), element 0
  always sampled, swapped values not cancelling, and the folds of the
  blocks of a sharded tensor (padded, cut twice) adding up to the
  logical tensor's;
- ``vote_verdict`` equal to the reference's on every case;
- the fold in the step beside the host recompute (within the
  reference's ``sdc_fp_rtol``), beside the reference's fold (1e-4
  relative) and, on the numpy oracles, bit-equal to it;
- ``sdc.flip_param`` (sticky self-check, vote, the quarantine's rollback
  to the snapshot before the divergence) and ``sdc.flip_grad`` (the
  shadow audit on the numpy oracle): the same counters in both
  packages, the parameters after the rollback within 1e-5 of each
  tensor's largest |value|;
- clean audits raise nothing and leave the trajectory bit for bit, a
  step the guard skipped raises nothing;
- the gang's SDC exit: the culprit blocklisted, the restart from the
  snapshot the gang names (a stub worker beating into the channel).

The reference's ``rows_quarantined``/``/readyz`` and ``build_info``
cases test its web status page; the port's page is held to them in
``tests/test_torch_web_status.py``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.observe import metrics as ref_metrics
from znicz_tpu.resilience import integrity as ref_integrity
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.resilience import integrity
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _config(**engine):
    for key, value in engine.items():
        setattr(root.common.engine, key, value)
        setattr(ref_root.common.engine, key, value)


def _both(name, snapshot_dir=None, max_epochs=2, seed=17, oracle=False):
    """The reference test's ``_build`` through both packages."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(96, 10)).astype(np.float32)
    labels = (rng.random(96) * 3).astype(np.int32)
    out = []
    for pkg, loader_cls, wf_cls, seed_all, device in (
            ("ref", RefLoader, RefWorkflow, ref_prng.seed_all,
             NumpyDevice() if oracle else XLADevice()),
            ("port", ArrayLoader, StandardWorkflow, prng.seed_all,
             "numpy" if oracle else "cpu")):
        seed_all(seed)
        snap = None if snapshot_dir is None else {
            "directory": os.path.join(snapshot_dir, pkg), "prefix": "sdc"}
        wf = wf_cls(
            name=name,
            loader_factory=lambda w, cls=loader_cls: cls(
                w, train_data=data[:72], train_labels=labels[:72],
                valid_data=data[72:], valid_labels=labels[72:],
                minibatch_size=12),
            layers=[{"type": "all2all_tanh",
                     "->": {"output_sample_shape": 16},
                     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                    {"type": "softmax", "->": {"output_sample_shape": 3},
                     "<-": {"learning_rate": 0.05,
                            "gradient_moment": 0.9}}],
            decision_config={"max_epochs": max_epochs},
            snapshotter_config=snap)
        wf._max_fires = 10 ** 6
        wf.initialize(device=device)
        out.append(wf)
    return out


def _counters(pkg, family, **labels) -> float:
    """A counter of either package's registry (0 when never counted)."""
    fam = (ref_metrics if pkg == "ref" else metrics).REGISTRY._families.get(
        family)
    if fam is None:
        return 0.0
    want = tuple(str(labels[n]) for n in fam.labelnames)
    return sum(float(child.value) for key, child in fam.items()
               if key == want)


def _both_counters(family, **labels) -> tuple[float, float]:
    return (_counters("ref", family, **labels),
            _counters("port", family, **labels))


def _weights(ref, port):
    for r, p in zip(ref.forwards, port.forwards):
        for name in ("weights", "bias"):
            vec = getattr(r, name)
            vec.map_read()
            yield np.asarray(vec.mem), getattr(p, name).detach().numpy()


# ----------------------------------------------------------------------
# the fingerprint algebra
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5,), (16, 16), (3, 4, 5), (1000,)])
def test_tensor_fingerprint_matches_the_reference(shape):
    import jax.numpy as jnp
    arr = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = float(ref_integrity.tensor_fingerprint(np, arr))
    assert float(integrity.tensor_fingerprint(arr)) == want
    assert float(ref_integrity.tensor_fingerprint(jnp, jnp.asarray(arr))) \
        == pytest.approx(want, rel=1e-5, abs=1e-5)
    got = float(integrity.fingerprint_partial(torch.from_numpy(arr)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert integrity.host_fingerprint(torch.from_numpy(arr)) == \
        pytest.approx(want, rel=1e-7, abs=1e-7)


def test_tensor_fingerprint_samples_element_zero():
    """The drill's flip target (element 0) is always sampled."""
    arr = np.zeros(10_000, dtype=np.float32)
    base = float(integrity.tensor_fingerprint(arr))
    arr[0] = 1000.0
    assert float(integrity.tensor_fingerprint(arr)) != base
    assert float(integrity.fingerprint_partial(torch.from_numpy(arr))) \
        != base


def test_tensor_fingerprint_position_sensitive():
    a = np.zeros(128, dtype=np.float32)
    b = np.zeros(128, dtype=np.float32)
    a[0], a[2] = 1.0, 2.0  # both sampled at stride 2
    b[0], b[2] = 2.0, 1.0  # swapped values must not cancel
    assert float(integrity.tensor_fingerprint(a)) \
        != float(integrity.tensor_fingerprint(b))


@pytest.mark.parametrize("shape,cuts", [
    ((10, 6), [(0, 4, 2)]),                    # ZeRO-1: 4 shards, pad 2
    ((12, 8), [(1, 2, 0)]),                    # a column-parallel block
    ((12, 8), [(1, 2, 0), (0, 2, 0)]),         # model, then data
    ((7, 5), [(0, 2, 1), (0, 2, 0)]),          # the same dim twice, padded
])
def test_block_folds_add_up_to_the_logical_tensor(shape, cuts):
    """Every block of a sharded tensor folds the samples that fall in it,
    by their logical positions; the folds add up to the logical
    tensor's fingerprint (the pad is never sampled)."""
    full = torch.from_numpy(np.random.default_rng(4).normal(size=shape)
                            .astype(np.float32))
    total = 0.0
    for index in np.ndindex(*[parts for _, parts, _ in cuts]):
        block, spec = full, []
        for (dim, parts, pad), i in zip(cuts, index):
            if pad:
                widths = [0, 0] * block.dim()
                widths[2 * (block.dim() - 1 - dim) + 1] = pad
                block = torch.nn.functional.pad(block, widths)
            size = block.shape[dim] // parts
            block = block.narrow(dim, i * size, size)
            spec.append((dim, parts, i, pad))
        total += float(integrity.fingerprint_partial(block, shape, spec))
    want = float(integrity.tensor_fingerprint(full.numpy()))
    assert total == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_vote_verdict_equals_the_reference():
    cases = [([1.0, 1.0, 1.0], [1.0, 1.0, 1.0], None),
             ([1.0, 5.0], [1.0, 1.0], None),
             ([1.0, 5.0], [1.0, 5.0], [0.0, 2.0]),
             ([1.0, 1.0, 7.0], [1.0, 1.0, 7.0], None),
             ([1.0, 5.0], [1.0, 5.0], None),
             ([1.0, 1.0, 7.0, 7.0], [1.0, 1.0, 7.0, 7.0], None),
             ([2.0], [2.0], [1.0])]
    for dev, host, flags in cases:
        assert integrity.vote_verdict(dev, host, 1e-3, self_flags=flags) \
            == ref_integrity.vote_verdict(dev, host, 1e-3, self_flags=flags)
    v = integrity.vote_verdict([1.0, 5.0], [1.0, 5.0], 1e-3)
    assert v["divergent"] and v["culprits"] == [0, 1]


# ----------------------------------------------------------------------
# the fold in the step beside the host recompute and the reference
# ----------------------------------------------------------------------
def test_device_fold_matches_host_recompute_and_the_reference():
    _config(sdc_vote_interval=4)
    ref, port = _both("fp_parity")
    ref.run()
    port.run()
    fp = port.integrity.read_device_fingerprint()
    assert fp is not None and fp[0] != 0.0 and fp[3] == 0.0
    host = integrity.host_param_fingerprint(port)
    assert abs(fp[0] - host) <= 1e-3 * max(abs(host), 1.0)
    np.testing.assert_allclose(fp, ref.integrity.read_device_fingerprint(),
                               rtol=1e-4)
    clean = _both_counters("znicz_sdc_votes_total", workflow="fp_parity",
                           verdict="clean")
    assert clean[0] == clean[1] >= 2
    assert _counters("port", "znicz_sdc_votes_total", workflow="fp_parity",
                     verdict="divergent") == 0
    # the numpy oracles fold the same algebra, bit for bit
    ref, port = _both("fp_parity_np", oracle=True, max_epochs=1)
    ref.run()
    port.run()
    fp_np = port.integrity.read_device_fingerprint()
    assert fp_np[0] != 0.0
    np.testing.assert_array_equal(fp_np,
                                  ref.integrity.read_device_fingerprint())
    assert abs(fp_np[0] - integrity.host_param_fingerprint(port)) \
        <= 1e-3 * max(abs(fp_np[0]), 1.0)


# ----------------------------------------------------------------------
# detection
# ----------------------------------------------------------------------
def test_flip_param_trips_sticky_selfcheck_and_vote(tmp_path):
    _config(sdc_vote_interval=4,
            faults={"sdc.flip_param": {"process": 0, "at": [6]}})
    before = {k: _both_counters(*k[:1], **dict(k[1:])) for k in (
        ("znicz_sdc_detected_total", ("kind", "vote")),
        ("znicz_sdc_suspect_total", ("process", "0"), ("device", "-")))}
    ref, port = _both("flip_param", snapshot_dir=str(tmp_path))
    ref.run()
    port.run()
    fp = port.integrity.read_device_fingerprint()
    assert fp[3] >= 1.0, "the self-check never tripped"
    assert fp[3] == ref.integrity.read_device_fingerprint()[3]
    div = _both_counters("znicz_sdc_votes_total", workflow="flip_param",
                         verdict="divergent")
    assert div[0] == div[1] >= 1
    for key, (r0, p0) in before.items():
        r1, p1 = _both_counters(key[0], **dict(key[1:]))
        assert p1 - p0 == r1 - r0 >= 1, key


def test_flip_param_quarantine_rolls_back_to_pre_divergence(tmp_path):
    """Without a supervisor the sentinel reloads the last snapshot a
    clean vote saw and the run goes on: finite, clean weights, as the
    reference's."""
    _config(sdc_vote_interval=3,
            faults={"sdc.flip_param": {"process": 0, "at": [14],
                                       "factor": 2.0 ** 16}})
    rollbacks = _both_counters("znicz_recoveries_total",
                               kind="sdc_rollback")
    quarantined = _both_counters("znicz_sdc_quarantined_total",
                                 kind="host")
    ref, port = _both("flip_rollback", snapshot_dir=str(tmp_path),
                      max_epochs=4)
    ref.run()
    port.run()
    after = _both_counters("znicz_recoveries_total", kind="sdc_rollback")
    assert after[1] - rollbacks[1] == after[0] - rollbacks[0] >= 1
    q = _both_counters("znicz_sdc_quarantined_total", kind="host")
    assert q[1] - quarantined[1] == q[0] - quarantined[0] >= 1
    w = port.forwards[0].weights.detach().numpy()
    assert np.isfinite(w).all() and np.abs(w).max() < 100.0
    for want, got in _weights(ref, port):
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_flip_grad_caught_by_shadow_audit():
    _config(sdc_audit_interval=3,
            faults={"sdc.flip_grad": {"process": 0, "after": 4,
                                      "factor": 64.0}})
    ref, port = _both("flip_grad")
    ref.run()
    port.run()
    for verdict in ("mismatch", "match"):
        got = _both_counters("znicz_sdc_audits_total", workflow="flip_grad",
                             verdict=verdict)
        assert got[0] == got[1] >= 1, verdict
    assert _counters("port", "znicz_sdc_detected_total", kind="audit") >= 1


def test_clean_audits_do_not_false_alarm():
    _config(sdc_audit_interval=2)
    before = _counters("port", "znicz_sdc_detected_total", kind="audit")
    ref, port = _both("audit_clean")
    ref.run()
    port.run()
    match = _both_counters("znicz_sdc_audits_total", workflow="audit_clean",
                           verdict="match")
    assert match[0] == match[1] >= 3
    assert _counters("port", "znicz_sdc_audits_total",
                     workflow="audit_clean", verdict="mismatch") == 0
    assert _counters("port", "znicz_sdc_detected_total",
                     kind="audit") == before


def test_audit_does_not_perturb_the_training_trajectory():
    """Audits on and off give the same weights bit for bit (the shadow
    replay moves neither the live generator nor a live tensor)."""
    finals = []
    for interval in (3, 0):
        root.common.engine.sdc_audit_interval = interval
        prng.seed_all(17)
        port = _both(f"audit_{interval}", max_epochs=2)[1]
        port.run()
        finals.append([t.detach().clone() for t in
                       (port.forwards[0].weights, port.forwards[1].weights)])
    for a, b in zip(*finals):
        assert torch.equal(a, b)


def test_guard_skip_does_not_false_alarm_selfcheck():
    """A step the guard skipped keeps the claimed fingerprint equal to
    the stored parameters: the self-check does not fire."""
    _config(sdc_vote_interval=4,
            faults={"train.nonfinite_loss": {"at": [5]}})
    ref, port = _both("guard_mix")
    ref.run()
    port.run()
    fp = port.integrity.read_device_fingerprint()
    assert fp[3] == 0.0 == ref.integrity.read_device_fingerprint()[3]
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state()
    assert _counters("port", "znicz_sdc_votes_total", workflow="guard_mix",
                     verdict="divergent") == 0


# ----------------------------------------------------------------------
# the gang's SDC exit
# ----------------------------------------------------------------------
_STUB = """\
import os, sys
sys.path.insert(0, {repo!r})
from znicz_tpu_torch.resilience import supervisor as sup
pid = int(os.environ["ZNICZ_PROCESS_ID"])
attempt = int(os.environ["ZNICZ_ELASTIC_ATTEMPT"])
w = sup.HeartbeatWriter(os.environ["ZNICZ_HEARTBEAT_DIR"], pid,
                        interval_s=0.05).start()
w.annotate(resumed_step=9 if attempt else 0)
for step in range(1, 7):
    w.beat(step)
    if attempt == 0 and step == 3:
        # the gang's verdict: every member annotates, the culprit exits
        # EXIT_SDC and its peer EXIT_PEER_LOST
        w.annotate(sdc_culprits=[1], sdc_last_good=os.environ["SDC_GOOD"],
                   sdc_detected={{"vote": 1}},
                   faults_injected=({{"sdc.flip_param": 1}} if pid == 1
                                    else {{}}))
        w.stop()
        os._exit(sup.EXIT_SDC if pid == 1 else sup.EXIT_PEER_LOST)
w.stop()
"""


def test_gang_sdc_exit_blocklists_and_resumes_pre_divergence(tmp_path):
    """A culprit's ``EXIT_SDC``: the host blocklisted, the gang restarted
    on the survivor from the snapshot the gang named, not the newest."""
    from znicz_tpu_torch.resilience import supervisor as sup
    from znicz_tpu_torch.utils.snapshotter import Snapshotter
    snaps = tmp_path / "snaps"
    good = Snapshotter.write({"good": True}, str(snaps), "sdc", "e1")
    time.sleep(0.05)
    Snapshotter.write({"post": True}, str(snaps), "sdc", "e2")  # newer
    stub = tmp_path / "stub.py"
    stub.write_text(_STUB.format(repo=REPO))
    before = _counters("port", "znicz_host_losses_total", kind="sdc")
    detected = _counters("port", "znicz_sdc_detected_total", kind="vote")
    supv = sup.ElasticSupervisor(
        lambda pid, n, attempt: [sys.executable, str(stub)],
        n_processes=2, work_dir=str(tmp_path / "work"),
        snapshot_dir=str(snaps), snapshot_prefix="sdc",
        heartbeat_timeout_s=60.0, start_grace_s=120.0,
        poll_interval_s=0.05, drain_s=30.0, max_restarts=2,
        env={"SDC_GOOD": good})
    summary = supv.run()
    assert summary["ok"] and summary["restarts"] == 1
    assert summary["losses"] == {"sdc": 1}
    assert summary["final_processes"] == 1
    assert summary["blocklisted"] == [1] == summary["sdc_culprits"]
    assert summary["resumed"] == "pre-divergence"
    assert summary["resume_snapshots"][1] == good
    assert summary["resumed_step"] == 9
    assert _counters("port", "znicz_host_losses_total", kind="sdc") \
        == before + 1
    assert _counters("port", "znicz_sdc_detected_total", kind="vote") \
        == detected + 1
