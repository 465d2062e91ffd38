"""The port's train-to-serve publisher
(``znicz_tpu_torch.resilience.publisher``) against the reference's, on
the CPU: the publication, watcher, canary, probation, prune and
snapshot-age cases of ``tests/test_swap.py``.

- bundles published by either package are picked up by the other's
  watcher: versions strictly rising, the digest sidecar, the newest
  version first, a corrupt newest refused with the fall-back to the
  older good one (counted), never retried;
- the swap controller over the port's ``ServingEngine`` (every bucket
  a region on the CPU): a candidate regressing past the margin refused
  with the incumbent serving bit for bit, the next good one promoted; a
  promoted bundle tripping its probation rolled back, the prior
  weights' replies bit for bit; the same verdicts as the reference's
  controller over its engine on the same bundles;
- the int8 publish: the port's quantized bundle carries the reference's
  quantization record, and the watcher of either package loads it;
- ``WeightPublisher`` every epoch through ``link_weight_publisher``;
- the snapshot prune (the newest good kept, corrupt ones not counted, a
  sidecarless one counted) equal to the reference's on the same files,
  and the snapshot-age gauge fed by a good write.

The reference's ``/readyz`` checks are ``tests/test_torch_web_status.
py``'s, its programs pack ``tests/test_torch_aot_cache.py``'s; its
decode-drain cases are ``tests/test_torch_decode_quant_swap.py``'s.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from conftest import make_blobs
from znicz_tpu.backends import XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.resilience import publisher as ref_pub
from znicz_tpu.serving import ServingEngine as RefEngine
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu.utils.snapshotter import Snapshotter as RefSnapshotter
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.resilience import publisher as pub
from znicz_tpu_torch.serving import ServingEngine
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

DIM, CLASSES = 10, 3


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


def _layers():
    return [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": CLASSES},
             "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]


def _build(pkg: str, name: str, max_epochs: int, seed: int = 17, **kw):
    """The reference test's ``_build_wf`` in either package, trained."""
    data, labels = make_blobs(24, CLASSES, DIM)
    loader_cls, wf_cls, seed_all, device = (
        (RefLoader, RefWorkflow, ref_prng.seed_all, XLADevice())
        if pkg == "ref" else
        (ArrayLoader, StandardWorkflow, prng.seed_all, "cpu"))
    seed_all(seed)
    wf = wf_cls(
        name=name,
        loader_factory=lambda w: loader_cls(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=_layers(), decision_config={"max_epochs": max_epochs}, **kw)
    wf._max_fires = 100_000
    wf.initialize(device=device)
    wf.run()
    return wf


# ----------------------------------------------------------------------
# publication and the watcher
# ----------------------------------------------------------------------
def test_publish_monotonic_versions_and_pickup(tmp_path):
    """The port publishes v1 and v2 (sidecars; the reference's manifest,
    and no programs pack with the kernel-library store off); both
    packages' watchers surface v2 first and then nothing; a bundle the
    reference publishes next is v3 to both."""
    wf = _build("port", "pub_wf", 1)
    pubdir = str(tmp_path / "published")
    v1, p1 = pub.publish_bundle(wf, pubdir)
    v2, p2 = pub.publish_bundle(wf, pubdir)
    assert (v1, v2) == (1, 2)
    assert os.path.exists(p2) and os.path.exists(p2 + ".sha256")
    for watcher in (pub.PublicationWatcher(pubdir),
                    ref_pub.PublicationWatcher(pubdir)):
        got = watcher.poll()
        assert got is not None and got[0] == 2, "the newest version wins"
        manifest, params = got[2], got[3]
        assert manifest["workflow"] == "pub_wf"
        assert "aot_programs" not in manifest
        assert not os.path.exists(p2[:-len(".npz")] + ".programs.npz")
        assert any(k.startswith("layer0_") for k in params)
        assert watcher.poll() is None, "nothing new: None"
    assert 0.0 <= metrics.snapshot_age_seconds("publish:model").value < 60
    ref_wf = _build("ref", "pub_ref", 1)
    v3, _ = ref_pub.publish_bundle(ref_wf, pubdir)
    watcher = pub.PublicationWatcher(pubdir)
    got = watcher.poll()
    assert v3 == 3 and got[0] == 3 and got[2]["workflow"] == "pub_ref"


def test_watcher_rejects_corrupt_falls_back(tmp_path):
    """``publish.corrupt`` flips bytes of v2 after its digest: each
    package's watcher refuses it, falls back to v1 (counted), never
    retries v2, and picks v3 up as usual."""
    wf = _build("port", "corrupt_wf", 1)
    pubdir = str(tmp_path / "published")
    pub.publish_bundle(wf, pubdir)
    root.common.engine.faults = {"publish.corrupt": {"at": [1]}}
    pub.publish_bundle(wf, pubdir)
    root.common.engine.faults = None
    fails = metrics.snapshot_failures("publish")
    before = fails.value
    watchers = (pub.PublicationWatcher(pubdir),
                ref_pub.PublicationWatcher(pubdir))
    for watcher in watchers:
        got = watcher.poll()
        assert got is not None and got[0] == 1, \
            "a corrupt newest falls back to the older good version"
        assert watcher.poll() is None  # v2 quarantined, never retried
    assert fails.value == before + 1
    pub.publish_bundle(wf, pubdir)
    for watcher in watchers:
        got = watcher.poll()
        assert got is not None and got[0] == 3


def test_int8_publish_carries_the_reference_quantization(tmp_path):
    """``quantize="int8"`` with a calibration stream: the staged bundle
    is rewritten as the reference's quantizer writes the same f32
    bundle (its record and its tensors), and both watchers load it."""
    from znicz_tpu.export import read_bundle as ref_read
    from znicz_tpu.serving import quantize as ref_quant
    data, labels = make_blobs(24, CLASSES, DIM)
    wf = _build("port", "int8_wf", 2)
    pubdir = str(tmp_path / "published")
    _, f32 = pub.publish_bundle(wf, pubdir)
    _, path = pub.publish_bundle(wf, pubdir, quantize="int8",
                                 calib=(data[48:], labels[48:]))
    manifest, params = ref_read(path)
    want_man, want_params, _ = ref_quant.quantize_bundle(
        *ref_read(f32), calib=(data[48:], labels[48:]))
    assert manifest["quant"] == want_man["quant"]
    for key, value in want_params.items():
        np.testing.assert_array_equal(params[key], value)
    for watcher in (pub.PublicationWatcher(pubdir),
                    ref_pub.PublicationWatcher(pubdir)):
        assert watcher.poll()[2]["quant"]["dtype"] == "int8"


def test_weight_publisher_every_epoch(tmp_path):
    """``link_weight_publisher`` publishes after each epoch's decision,
    version by version, the last one the trained weights."""
    data, labels = make_blobs(24, CLASSES, DIM)
    prng.seed_all(17)
    wf = StandardWorkflow(
        name="wp_wf",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:48], train_labels=labels[:48],
            valid_data=data[48:], valid_labels=labels[48:],
            minibatch_size=12),
        layers=_layers(), decision_config={"max_epochs": 3})
    pubdir = str(tmp_path / "published")
    p = wf.link_weight_publisher(directory=pubdir, prefix="wp")
    wf.initialize(device="cpu")
    wf.run()
    assert [v for v, _ in p.published] == [1, 2, 3]
    got = pub.PublicationWatcher(pubdir, prefix="wp").poll()
    np.testing.assert_array_equal(
        got[3]["layer0_weights"], wf.forwards[0].weights.numpy())


# ----------------------------------------------------------------------
# the canary gate and the probation rollback
# ----------------------------------------------------------------------
def _controlled(pkg, tmp_path):
    """A trained workflow of ``pkg`` publishing into its own directory
    and an engine of ``pkg`` serving its v1 under a swap controller."""
    data, labels = make_blobs(24, CLASSES, DIM)
    mod, engine_cls = (ref_pub, RefEngine) if pkg == "ref" \
        else (pub, ServingEngine)
    wf = _build(pkg, f"ctl_{pkg}", 2)
    pubdir = str(tmp_path / pkg)
    _, p1 = mod.publish_bundle(wf, pubdir)
    kwargs = {} if pkg == "ref" else {"device": "cpu"}
    eng = engine_cls(p1, max_batch=8, max_delay_ms=1.0, **kwargs)
    eng.start()
    eng.set_model_version(1)
    watcher = mod.PublicationWatcher(pubdir)
    watcher.version = 1
    ctl = mod.SwapController(eng, watcher,
                             mod.classifier_score(data[48:], labels[48:]),
                             guard_margin=0.05, probation_steps=1)
    return wf, pubdir, eng, ctl, mod


def test_canary_rejects_regressing_candidate(tmp_path):
    x = np.random.default_rng(8).normal(size=(3, DIM)).astype(np.float32)
    verdicts = {}
    for pkg in ("ref", "port"):
        wf, pubdir, eng, ctl, mod = _controlled(pkg, tmp_path)
        try:
            incumbent = np.asarray(eng(x, timeout=60))
            _config(faults={"swap.canary_regress": {"at": [1]}})
            mod.publish_bundle(wf, pubdir)
            first = ctl.tick()
            assert eng.model_version == 1
            np.testing.assert_array_equal(incumbent,
                                          np.asarray(eng(x, timeout=60)))
            _config(faults=None)
            mod.publish_bundle(wf, pubdir)
            second = ctl.tick()
            verdicts[pkg] = ([e.split(" ")[0] for e in first + second],
                             dict(eng.swap_counts), eng.model_version)
        finally:
            eng.shutdown()
    assert verdicts["port"] == verdicts["ref"] == (
        ["rejected", "promoted"],
        {"promoted": 1, "rejected": 1, "rolled_back": 0}, 3)


def test_probation_rollback_restores_prior(tmp_path):
    x = np.random.default_rng(9).normal(size=(3, DIM)).astype(np.float32)
    verdicts = {}
    for pkg in ("ref", "port"):
        wf, pubdir, eng, ctl, mod = _controlled(pkg, tmp_path)
        try:
            incumbent = np.asarray(eng(x, timeout=60))
            _config(faults={"swap.probation_fail": {"at": [1]}})
            mod.publish_bundle(wf, pubdir)
            events = ctl.tick()
            promoted = eng.model_version == 2 and ctl.on_probation
            events += ctl.tick()  # the probation check fires: rollback
            _config(faults=None)
            assert promoted and eng.model_version == 1 \
                and not ctl.on_probation
            np.testing.assert_array_equal(
                incumbent, np.asarray(eng(x, timeout=60)),
                err_msg="the rollback did not restore the prior weights")
            verdicts[pkg] = ([e.split(" ")[0] for e in events],
                             eng.swap_counts["rolled_back"])
        finally:
            eng.shutdown()
    assert verdicts["port"] == verdicts["ref"] == (["promoted", "rolled"], 1)


# ----------------------------------------------------------------------
# the snapshot prune and the snapshot-age gauge
# ----------------------------------------------------------------------
def _prune_both(tmp_path, build, keep_last):
    """The same files pruned by each package; returns the survivors'
    names of each."""
    out = []
    for pkg, snap in (("ref", RefSnapshotter), ("port", Snapshotter)):
        d = str(tmp_path / pkg)
        prefix, paths = build(d)
        snap.prune(d, prefix, keep_last=keep_last)
        out.append(sorted(os.path.basename(p) for p in paths
                          if os.path.exists(p)))
    return out


def test_prune_keeps_newest_good_skips_corrupt(tmp_path):
    def build(d):
        paths = []
        for i in range(5):
            paths.append(Snapshotter.write({"i": i}, d, "race", f"e{i}"))
            os.utime(paths[-1], (1000 + i, 1000 + i))
        for p in paths[3:]:  # the two newest: their sidecars now lie
            with open(p, "r+b") as f:
                f.write(b"\x00garbage\x00")
        return "race", paths

    ref_left, port_left = _prune_both(tmp_path, build, 2)
    assert port_left == ref_left == ["race_e1.pickle.gz", "race_e2.pickle.gz"]
    state = Snapshotter.load(str(tmp_path / "port" / "race_e2.pickle.gz"))
    assert state["i"] == 2


def test_prune_unverifiable_sidecarless_counts_as_good(tmp_path):
    def build(d):
        paths = []
        for i in range(3):
            paths.append(Snapshotter.write({"i": i}, d, "bare", f"e{i}"))
            os.utime(paths[-1], (1000 + i, 1000 + i))
        os.unlink(paths[2] + ".sha256")
        return "bare", paths

    ref_left, port_left = _prune_both(tmp_path, build, 2)
    assert port_left == ref_left == ["bare_e1.pickle.gz", "bare_e2.pickle.gz"]


def test_snapshot_age_gauge(tmp_path):
    """A good snapshot write feeds ``znicz_snapshot_age_seconds`` (the
    gauge a readiness probe reads), as the reference's does; staleness
    grows from the write."""
    wf = _build("port", "age_wf", 2,
                snapshotter_config={"prefix": "age",
                                    "directory": str(tmp_path)})
    assert wf.snapshotter.destination is not None
    gauge = metrics.snapshot_age_seconds("snapshot:age")
    assert 0.0 <= gauge.value < 120.0
    pub._last_written["snapshot:age"] -= 100
    assert gauge.value >= 100
