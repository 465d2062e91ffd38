"""The port's MLP family against the reference, on the CPU: the MSE
evaluator and decision, the confusion counts, the Wine, MNIST 784-100-10
and MNIST-784 autoencoder samples, and the Wine sample through the
command line.

- ``EvaluatorMSE`` on seeded outputs and targets with a short minibatch
  (5 of 8 rows valid) against the reference's ``numpy_run`` and
  ``xla_run``: ``err_output``, the step's SSE and the epoch sums within
  1e-6 relative (f32 sums in another order); a non-finite step leaves
  the epoch sum alone in both.
- The samples step side by side from one seed (the reference on its XLA
  CPU backend, its anomaly guard off, which changes no finite step):
  each parameter and momentum tensor within 1e-5 of its largest |value|
  (f32 summation order; measured ~2e-7 a step), the error counts and
  confusion counts exactly.  The autoencoder amplifies such differences
  step by step, so each of its steps starts from the reference's state,
  and its free-running MSE by epoch is held within 1e-4 relative.
- The Wine golden bound of ``tests/test_functional_real.py:39``: 40
  epochs on the real UCI data reach at most 2 of 28 validation errors.
- ``python -m znicz_tpu_torch wine wine_config -b cpu`` trains, and a
  run resumed with ``-s`` from its snapshot ends bit-equal to the
  uninterrupted run, with and without a learning-rate schedule (C9).
"""

import numpy as np
import pytest
import torch

from znicz_tpu import datasets as ref_datasets
from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.models.samples import mnist as ref_mnist
from znicz_tpu.models.samples import mnist784 as ref_mnist784
from znicz_tpu.models.samples import wine as ref_wine
from znicz_tpu.ops.evaluator import EvaluatorMSE as RefEvaluatorMSE
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch import datasets
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.loader.base import TEST, TRAIN, VALID
from znicz_tpu_torch.models.samples import mnist, mnist784, wine
from znicz_tpu_torch.ops.evaluator import EvaluatorMSE
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

SEED = 12
#: parameters and momentum, relative to the tensor's largest |value|
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    ref_root.common.engine.anomaly_guard = False  # the port has none
    yield
    reset_root()


# -- the datasets ------------------------------------------------------------
@pytest.mark.parametrize("name", ["load_wine", "_synthetic_wine",
                                  "load_digits", "load_mnist"])
def test_datasets_match_the_reference(name):
    """The same arrays in both packages (the UCI sets of scikit-learn,
    permuted with the reference's seeds; MNIST's synthetic stand-in, no
    idx files being here)."""
    want = getattr(ref_datasets, name)()
    got = getattr(datasets, name)()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert datasets.mnist_is_real() == ref_datasets.mnist_is_real() is False


# -- EvaluatorMSE -----------------------------------------------------------
def _mse_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, 2, 5)).astype(np.float32),
            rng.normal(size=(8, 10)).astype(np.float32))


def _ref_mse(device, y, t, valid, cls):
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(y, name="y"),
                    target=Vector(t, name="t"),
                    valid=Vector(np.asarray(valid, np.int32), name="v"))
    ev = RefEvaluatorMSE(wf)
    ev.link_attrs(src, "output", "target", ("minibatch_valid", "valid"))
    ev.minibatch_class = cls
    ev.initialize(device=device)
    return ev


def _port_mse(valid):
    ev = EvaluatorMSE()
    ev.initialize(device="cpu")
    ev.minibatch_valid = torch.tensor(valid)
    return ev


@pytest.mark.parametrize("backend", ["numpy_run", "xla_run"])
def test_evaluator_mse_matches_the_reference(backend):
    y, t = _mse_inputs()
    device = NumpyDevice() if backend == "numpy_run" else XLADevice()
    ref = _ref_mse(device, y, t, 5, VALID)
    port = _port_mse(5)
    for cls in (VALID, TRAIN, TRAIN):
        ref.minibatch_class = cls
        ref.run()
        err = port.evaluate(torch.from_numpy(y), torch.from_numpy(t), cls)
        for vec in (ref.err_output, ref.metrics, ref.epoch_sse):
            vec.map_read()
        np.testing.assert_allclose(err.numpy(), ref.err_output.mem,
                                   rtol=1e-6, atol=1e-7)
        assert err.shape == y.shape and not err[5:].any()
        np.testing.assert_allclose(float(port.metrics),
                                   float(ref.metrics.mem), rtol=1e-6)
        np.testing.assert_allclose(port.epoch_sse.numpy(),
                                   ref.epoch_sse.mem, rtol=1e-6)
    # a non-finite step is left out of the epoch sum
    before = port.epoch_sse.clone()
    bad = y.copy()
    bad[0, 0, 0] = np.nan
    port.evaluate(torch.from_numpy(bad), torch.from_numpy(t), TRAIN)
    assert torch.isnan(port.metrics)
    assert torch.equal(port.epoch_sse, before)


# -- the samples side by side ----------------------------------------------
def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()
    if wf.lr_adjuster is not None:
        wf.lr_adjuster._fire()


def _ref_params(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in ("weights", "bias", "accumulated_gradient_weights",
                     "accumulated_gradient_bias"):
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.array(vec.mem, np.float32)
    return out


def _port_params(wf) -> dict:
    return {f"{u.name}.{name}": t.detach().numpy().copy()
            for u in [*wf.forwards, *wf.gds]
            for name, t in [*u.named_parameters(recurse=False),
                            *u.named_buffers(recurse=False)]}


def _assert_close(port, ref):
    want, got = _ref_params(ref), _port_params(port)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=key)


def _pair(ref_module, port_module, **kwargs):
    ref_prng.seed_all(SEED)
    ref = ref_module.build(**kwargs)
    ref.initialize(device=XLADevice())
    prng.seed_all(SEED)
    port = port_module.build(**kwargs)
    port.initialize(device="cpu")
    return ref, port


def test_mnist_steps_match_the_reference():
    """MNIST 784-100-10 on the synthetic set (the idx files are not
    here): the test and validation minibatches of the first epoch, then
    train steps."""
    ref, port = _pair(ref_mnist, mnist)
    assert port.loader.class_lengths == [1000, 600, 5400]
    x = port.loader.original_data
    assert x.dtype == torch.uint8 and tuple(x.shape[1:]) == (784,)
    classes = []
    for _ in range(19):  # 10 test, 6 validation, 3 train
        _ref_step(ref)
        port.step()
        classes.append(port.loader.minibatch_class)
        _assert_close(port, ref)
        ref.evaluator.epoch_n_err.map_read()
        np.testing.assert_array_equal(port.evaluator.epoch_n_err.numpy(),
                                      ref.evaluator.epoch_n_err.mem)
    assert classes == [TEST] * 10 + [VALID] * 6 + [TRAIN] * 3
    # pixels scaled to [−1, 1] (255 lands one f32 ulp above 1)
    data = port.loader.minibatch_data
    assert float(data.min()) == -1.0 and float(data.max()) <= 1.0 + 1e-6


def test_mnist784_autoencoder_steps_match_the_reference():
    """Two epochs of the autoencoder (600 images: 100 test, 60
    validation, 540 train, 8 steps an epoch), each step from the
    reference's state (its snapshot loaded into the port): the MSE loss
    with no labels anywhere, its target the normalized input minibatch.
    Its updates amplify an f32 difference about threefold a step
    (measured: 1e-7 after the first train step, 1.5e-5 of the momentum
    after the sixth), so each step starts from the same state, and the
    next test holds the free-running trajectory."""
    ref, port = _pair(ref_mnist784, mnist784, n_train_samples=600,
                      max_epochs=2)
    loader = port.loader
    assert loader.original_labels is None
    assert port.evaluator._linked_attrs["target"].source is loader
    for _ in range(16):
        port.load_state(ref.state_dict())
        _ref_step(ref)
        port.step()
        _assert_close(port, ref)
        ref.evaluator.epoch_sse.map_read()
        np.testing.assert_allclose(port.evaluator.epoch_sse.numpy(),
                                   ref.evaluator.epoch_sse.mem, rtol=1e-6)
        assert loader.minibatch_labels is None
        # the target is the gathered minibatch, pixels scaled to [0, 1]
        want = loader.original_data.index_select(
            0, loader.minibatch_indices).float() * np.float32(1 / 255)
        assert torch.equal(port.evaluator.target, want)
    assert port.decision.complete and ref.decision.complete
    state = port.decision.state_dict()
    assert set(state) == set(ref.decision.SNAPSHOT_ATTRS)


def test_mnist784_mse_by_epoch_matches_the_reference():
    """The same two epochs free-running from one seed: the MSE by epoch
    and class within 1e-4 relative (the amplified f32 differences of
    the test above; measured 5e-6), falling on the train set, and the
    best validation MSE the reference's."""
    ref, port = _pair(ref_mnist784, mnist784, n_train_samples=600,
                      max_epochs=2)
    while not ref.decision.complete:
        _ref_step(ref)
    port.run()
    assert port.loader.epoch_number == ref.loader.epoch_number == 1
    for cls in (TEST, VALID, TRAIN):
        got = port.decision.epoch_mse_history[cls]
        want = ref.decision.epoch_mse_history[cls]
        assert len(got) == 2
        np.testing.assert_allclose(got, want, rtol=1e-4)
    train = port.decision.epoch_mse_history[TRAIN]
    assert train[1] < train[0]
    assert port.decision.min_validation_mse == pytest.approx(
        ref.decision.min_validation_mse, rel=1e-4)


def test_confusion_counts_match_the_reference():
    """Wine with ``compute_confusion``: an epoch and a half, the
    device counts mid-epoch and the decision's matrices of the finished
    epoch equal the reference's."""
    config = {"evaluator_config": {"compute_confusion": True}}
    ref, port = _pair(ref_wine, wine, **config)
    for step in range(27):  # an epoch of 18 steps, then 9 more
        _ref_step(ref)
        port.step()
        if step in (4, 26):
            ref.evaluator.confusion_matrix.map_read()
            np.testing.assert_array_equal(
                port.evaluator.confusion_matrix.numpy(),
                ref.evaluator.confusion_matrix.mem)
    _assert_close(port, ref)
    assert port.decision.last_epoch_n_err == ref.decision.last_epoch_n_err
    for got, want in zip(port.decision.confusion_matrixes,
                         ref.decision.confusion_matrixes):
        np.testing.assert_array_equal(got, want)
    cm = port.decision.confusion_matrixes
    assert cm[VALID].sum() == 28 and cm[TRAIN].sum() == 150
    assert cm[VALID].sum() - np.trace(cm[VALID]) == \
        port.decision.last_epoch_n_err[VALID]


def test_wine_golden_bound():
    """The bar of ``tests/test_functional_real.py:39``: at most 2 of 28
    validation errors after 40 epochs on the real UCI data."""
    data, labels = datasets.load_wine()
    assert data.shape == (178, 13) and datasets.wine_is_real()
    assert sorted(np.bincount(labels).tolist()) == [48, 59, 71]
    wf = wine.build(max_epochs=40)
    wf.initialize(device="cpu")
    wf.run()
    assert wf.loader.epoch_number + 1 == 40
    assert int(wf.decision.min_validation_n_err) <= 2


def _final(wf) -> dict:
    state = wf.state_dict()
    return {"units": state["__units__"], "prng": state["__prng__"]}


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("schedule", [None, "exp"])
def test_cli_wine_config_trains_and_resumes(tmp_path, schedule):
    """``wine wine_config -b cpu`` for its 12 epochs with snapshots (on
    each improvement), then a run resumed with ``-s`` from its last
    snapshot, written at least two epochs before the end, ends bit-equal
    to it.  With a schedule the snapshot must hold the iteration count
    of the step it closes (C9): one behind, the resumed run would take
    other rates."""
    args = ["wine", "wine_config", "-b", "cpu", "--root",
            f"wine.snapshotter_config={{'prefix': 'wine', 'directory': "
            f"'{tmp_path}'}}"]
    if schedule:
        args += ["--root", "wine.lr_adjuster_config={'lr_policy': "
                 "('exp', {'gamma': 0.99})}"]
    straight = Main()
    assert straight.run(args) == 0
    wf = straight.launcher.workflow
    assert wf.loader.epoch_number + 1 == 12 and wf.decision.complete
    assert wf.gds[0].learning_rate == 0.5  # wine_config's
    if schedule:
        assert wf.lr_adjuster._n_iterations == 12 * 15
        np.testing.assert_array_equal(
            wf.gds[0].lr_state.numpy(), np.float32([0.5 * 0.99 ** 180] * 2))
    snapshot = wf.snapshotter.destination
    state = Snapshotter.load(snapshot)
    assert state["__units__"][wf.loader.name]["epoch_number"] <= 9
    resumed = Main()  # root keeps wine_config's leaves
    assert resumed.run(args + ["-s", snapshot]) == 0
    wf2 = resumed.launcher.workflow
    assert wf2.loader.epoch_number + 1 == 12
    _assert_same(_final(wf2), _final(wf))


def test_mse_over_a_softmax_layer_matches_the_reference():
    """C12: ``loss="mse"`` over ``all2all_tanh(8) → softmax(6)`` on an
    ``ArrayLoader`` of 6 features, the target the input itself.  The
    reference links ``EvaluatorMSE`` to whatever the last layer is, and
    its linear ``GDSoftmax`` takes the MSE error at the probabilities as
    it comes; the port trains the same configuration for 3 epochs on its
    CPU device against the reference's ``xla_run``: the validation MSE
    by epoch and the weights within 1e-5, the MSE falling."""
    from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
    from znicz_tpu.models.standard_workflow import \
        StandardWorkflow as RefWorkflow
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow

    rng = np.random.default_rng(7)
    x = rng.normal(size=(60, 6)).astype(np.float32)
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
               "<-": {"learning_rate": 0.05, "gradient_moment": 0.5}},
              {"type": "softmax", "->": {"output_sample_shape": 6},
               "<-": {"learning_rate": 0.05, "gradient_moment": 0.5}}]

    def build(cls, loader):
        return cls(name="c12", loss="mse", layers=layers,
                   loader_factory=lambda w: loader(
                       w, train_data=x[20:], valid_data=x[:20],
                       minibatch_size=10),
                   decision_config={"max_epochs": 3})

    ref_prng.seed_all(SEED)
    ref = build(RefWorkflow, RefLoader)
    ref.initialize(device=XLADevice())
    prng.seed_all(SEED)
    port = build(StandardWorkflow, ArrayLoader)
    port.initialize(device="cpu")
    assert isinstance(port.evaluator, EvaluatorMSE)
    while not ref.decision.complete:
        _ref_step(ref)
    port.run()
    want = ref.decision.epoch_mse_history[VALID]
    got = port.decision.epoch_mse_history[VALID]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[0] > want[1] > want[2]
    _assert_close(port, ref)
