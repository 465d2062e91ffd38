"""The port's snapshots: the format, its integrity checks, and resume
across packages, on the CPU.

A snapshot is the reference's file: a gzip'd pickle of the workflow's
``state_dict()`` with a ``.sha256`` sidecar.  The tests hold the
sidecar, the fallback from a corrupt file to the newest good one, the
pruning, the absorbed write failure, a snapshot the reference wrote
loading into the port (the next steps then match the reference's), one
the port wrote loading into the reference, and the decision's and
evaluator's state coming back with the rest (a resumed run that forgot
its best validation error would snapshot at the wrong epoch, under the
wrong name, and count its stop rule from zero).

The workflow is CIFAR's layer kinds at a small size: conv → MaxAbs pool
→ LRN → avg pool → softmax on 8×8×3 uint8 images, minibatch 4, with a
test, a validation and a train set.  Tolerance of the steps after a
reference snapshot, f32: 1e-5 of the largest |reference| of each
tensor (summation order only).
"""

import gzip
import os
import pickle

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.snapshotter import Snapshotter as RefSnapshotter
from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import SnapshotCorrupt, Snapshotter

TOL = 1e-5
SEED = 17


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _layers():
    gd = {"learning_rate": 0.05, "gradient_moment": 0.9,
          "weights_decay": 5e-4}
    return [{"type": "conv_str", "->": {"n_kernels": 6, "kx": 3, "ky": 3,
                                        "padding": 1}, "<-": gd},
            {"type": "maxabs_pooling", "->": {"kx": 3, "ky": 3,
                                              "sliding": (2, 2)}},
            {"type": "norm", "->": {"n": 5, "alpha": 5e-5, "beta": 0.75}},
            {"type": "avg_pooling", "->": {"kx": 3, "ky": 3,
                                           "sliding": (2, 2)}},
            {"type": "softmax", "->": {"output_sample_shape": 4},
             "<-": gd}]


def _loader(cls):
    x, y, tx, ty = datasets.synthetic_images(
        n_train=24, n_test=8, size=8, channels=3, n_classes=4, seed=5)
    return lambda w: cls(w, train_data=x[8:], train_labels=y[8:],
                         valid_data=x[:8], valid_labels=y[:8],
                         test_data=tx, test_labels=ty, minibatch_size=4,
                         normalization_scale=2.0 / 255.0,
                         normalization_bias=-1.0)


def _port(seed=SEED, **kwargs):
    prng.seed_all(seed)
    wf = StandardWorkflow(name="snap", loader_factory=_loader(ArrayLoader),
                          layers=_layers(), **kwargs)
    wf.initialize(device="cpu")
    return wf


def _reference(seed=SEED):
    ref_prng.seed_all(seed)
    wf = RefWorkflow(name="snap", loader_factory=_loader(RefLoader),
                     layers=_layers(), decision_config={"max_epochs": 100})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    return wf


def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()


def _ref_params(wf):
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in ("weights", "bias", "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.array(vec.mem, np.float32)
    return out


def _port_params(wf):
    return {f"{unit.name}.{name}": t.detach().float().numpy().copy()
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]}


DECISION_KEYS = ("epoch_n_err", "epoch_n_err_pt", "min_validation_n_err",
                 "min_validation_n_err_pt", "min_train_n_err",
                 "_epochs_without_improvement")


def _write_some(directory, prefix, n):
    paths = []
    for i in range(n):
        paths.append(Snapshotter.write({"i": i, "a": np.arange(i + 3)},
                                       str(directory), prefix, f"{i}"))
        os.utime(paths[-1], (1000.0 + i, 1000.0 + i))  # distinct mtimes
    return paths


def test_write_leaves_a_sidecar_with_the_digest(tmp_path):
    path = Snapshotter.write({"x": np.ones(3)}, str(tmp_path), "p", "s")
    assert path == str(tmp_path / "p_s.pickle.gz")
    import hashlib
    with open(path, "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    with open(path + ".sha256") as f:
        assert f.read().strip() == want
    with gzip.open(path, "rb") as f:
        assert np.array_equal(pickle.load(f)["x"], np.ones(3))
    np.testing.assert_array_equal(Snapshotter.load(path)["x"], np.ones(3))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_corrupt_newest_falls_back_to_the_previous_good_one(tmp_path):
    older, newer = _write_some(tmp_path, "p", 2)
    with open(newer, "r+b") as f:  # flip a byte: the digest disagrees
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    failures = metrics.snapshot_failures("load").value
    fallbacks = metrics.recoveries("snapshot_fallback").value
    assert Snapshotter.load(newer)["i"] == 0
    assert metrics.snapshot_failures("load").value == failures + 1
    assert metrics.recoveries("snapshot_fallback").value == fallbacks + 1
    # a truncated stream without a sidecar is caught by gzip/pickle
    os.unlink(newer + ".sha256")
    with open(newer, "wb") as f:
        f.write(b"\x1f\x8b\x08")
    assert Snapshotter.load(newer)["i"] == 0


def test_all_corrupt_raises(tmp_path):
    for path in _write_some(tmp_path, "p", 2):
        with open(path, "ab") as f:
            f.write(b"junk")
    with pytest.raises(SnapshotCorrupt, match="no fallback"):
        Snapshotter.load(str(tmp_path / "p_1.pickle.gz"))


def test_keep_last_prunes_the_oldest_and_the_corrupt(tmp_path):
    paths = _write_some(tmp_path, "p", 5)
    with open(paths[3], "ab") as f:
        f.write(b"junk")
    other = Snapshotter.write({}, str(tmp_path), "q", "0")  # another prefix
    deleted = Snapshotter.prune(str(tmp_path), "p", keep_last=2)
    # the corrupt file takes no place among the two kept
    assert sorted(deleted) == [paths[0], paths[1], paths[3]]
    kept = [paths[2], paths[4], other]
    assert sorted(os.listdir(tmp_path)) == sorted(
        name for p in kept for name in (os.path.basename(p),
                                        os.path.basename(p) + ".sha256"))


def test_the_workflow_snapshots_on_improvement_and_prunes(tmp_path):
    """The snapshotter fires after each epoch whose validation error
    improved, names the file by it, and keeps ``keep_last`` files."""
    wf = _port(decision_config={"max_epochs": 4},
               snapshotter_config={"prefix": "snap", "keep_last": 2,
                                   "directory": str(tmp_path)})
    fired = []
    run = wf.snapshotter.run
    wf.snapshotter.run = lambda: fired.append(
        (wf.loader.epoch_number, wf.decision.improved)) or run()
    wf.run()
    assert fired and all(improved for _, improved in fired)
    assert wf.snapshotter.destination == str(
        tmp_path / f"snap_{wf.decision.min_validation_n_err_pt:.2f}pt"
                   ".pickle.gz")
    files = [p for p in os.listdir(tmp_path) if p.endswith(".pickle.gz")]
    assert len(files) == min(2, len(set(fired)))


def test_a_failed_write_is_absorbed_and_counted(tmp_path):
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    wf = _port(decision_config={"max_epochs": 1},
               snapshotter_config={"directory": str(blocker / "x")})
    failures = metrics.snapshot_failures("write").value
    wf.run()  # epoch 0 improves: the snapshotter fires and fails
    assert metrics.snapshot_failures("write").value == failures + 1
    assert wf.snapshotter.destination is None
    root.common.engine.snapshot_tolerate_failures = False
    with pytest.raises(OSError):
        wf.snapshotter.run()


def test_c8_decision_and_evaluator_state_come_back():
    """C8: ``load_state`` restores the decision's best errors and epochs
    without improvement and the evaluator's epoch counters, not only the
    parameters, the loader and the generator."""
    wf = _port(decision_config={"max_epochs": 100, "fail_iterations": 5})
    for _ in range(8 + 5):  # an epoch and into the next
        wf.step()
    wf.decision._epochs_without_improvement = 3
    wf.decision.min_validation_n_err_pt = 12.5
    state = pickle.loads(pickle.dumps(wf.state_dict()))
    fresh = _port(seed=99, decision_config={"max_epochs": 100,
                                            "fail_iterations": 5})
    fresh.load_state(state)
    assert fresh.decision.min_validation_n_err_pt == 12.5
    assert fresh.decision._epochs_without_improvement == 3
    for key in DECISION_KEYS:
        assert getattr(fresh.decision, key) == getattr(wf.decision, key), key
    for key in ("epoch_n_err", "epoch_loss"):
        assert torch.equal(getattr(fresh.evaluator, key),
                           getattr(wf.evaluator, key)), key
    # a decision or evaluator key the state lacks keeps its value
    del state["__units__"]["decision"]["min_train_n_err"]
    del state["__units__"]["evaluator"]["epoch_loss"]
    lenient = _port(decision_config={"max_epochs": 100})
    lenient.load_state(state)
    assert lenient.decision.min_train_n_err is None
    assert not lenient.evaluator.epoch_loss.any()
    # ... and a missing parameter still raises
    del state["__units__"]["ConvStrictRELU"]["weights"]
    with pytest.raises(KeyError, match="ConvStrictRELU.weights"):
        lenient.load_state(state)


def test_a_reference_snapshot_resumes_in_the_port(tmp_path):
    """The reference trains across an epoch boundary and writes its
    snapshot; the port loads the file and its next three steps match
    the reference's next three."""
    ref = _reference()
    for _ in range(11):
        _ref_step(ref)
    path = RefSnapshotter.write(ref.state_dict(), str(tmp_path), "ref", "a")
    port = _port(seed=3, decision_config={"max_epochs": 100})
    port.load_state(Snapshotter.load(path))
    for key in DECISION_KEYS:
        assert getattr(port.decision, key) == getattr(ref.decision, key), key
    assert port.loader.epoch_number == ref.loader.epoch_number == 1
    for _ in range(3):
        _ref_step(ref)
        port.step()
        want, got = _ref_params(ref), _port_params(port)
        assert set(got) == set(want)
        for key, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(got[key] - w).max()) <= TOL * scale, key


def test_a_port_snapshot_loads_in_the_reference(tmp_path):
    """The port trains across an epoch boundary and its snapshotter
    writes the file; the reference's ``Snapshotter.load`` and
    ``Workflow.load_state`` take it, with the same parameters and
    decision counters."""
    port = _port(decision_config={"max_epochs": 100},
                 snapshotter_config={"prefix": "port",
                                     "directory": str(tmp_path)})
    for _ in range(11):
        port.step()
    port.snapshotter.run()
    state = RefSnapshotter.load(port.snapshotter.destination)
    ref = _reference(seed=4)
    ref.load_state(state)
    want, got = _port_params(port), _ref_params(ref)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in DECISION_KEYS:
        assert getattr(ref.decision, key) == getattr(port.decision, key), key
    ref.evaluator.epoch_n_err.map_read()
    np.testing.assert_array_equal(ref.evaluator.epoch_n_err.mem,
                                  port.evaluator.epoch_n_err.numpy())
    assert ref.loader._cursor == port.loader._cursor


def test_the_generator_state_carries_the_reference_key():
    """A generator seeded in the port writes the key the reference
    derives from its seed; a reference key it was given is kept."""
    import jax
    prng.seed_all(1234)
    state = prng.get().get_state()
    np.testing.assert_array_equal(
        state["jax_key"], np.asarray(jax.random.key_data(
            jax.random.key(1234))))
    state["jax_key"] = np.array([7, 9], np.uint32)
    prng.get().set_state(state)
    np.testing.assert_array_equal(prng.get().get_state()["jax_key"], [7, 9])
