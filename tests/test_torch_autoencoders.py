"""The port's conv autoencoders against the reference's, on the CPU (the
port of ``tests/test_autoencoders.py`` and of
``tests/test_export_publish.py::test_export_autoencoder_tied_layers``).

- The tiny conv AE (conv → max pooling → depooling tied to the pooling
  → deconv tied to the conv), with and without ``tied_weights``,
  trained side by side with the reference for two epochs from one seed:
  every parameter and momentum after every step, f32 on the reference's
  XLA path, bf16 on it in a subprocess with
  ``--xla_allow_excess_precision=false`` (C4: XLA's CPU compiler
  otherwise drops the bf16 rounding of the reference's conv outputs).
- Tied weights are one tensor: the deconv's ``weights`` is the conv's
  parameter, through a step, a snapshot and a resume in either package;
  a snapshot written by the reference resumes in the port and one
  written by the port resumes in the reference.
- ``mnist_ae`` and ``imagenet_ae`` at the reference test's reduced
  sizes (the latter's pooling window cut at the edge) against the
  reference's samples.
- C13: ``tied_to`` on a layer that is neither a deconv nor a depooling
  is refused, with the reference's message.
- ``run_chunked`` bit-equal to ``run()`` for the tiny AE.
- The AE bundle written by either package loads in the port with its
  ties and serves the reference's ``ExportedModel`` replies.

Tolerances, relative to the largest |reference| of each tensor:

- f32: 1e-5 — the same products in other summation orders;
- bf16: 1e-4 — both round at the same points (the conv and transposed
  conv outputs, δ, the stored activations and errors, the momentum);
  summation order flips single roundings;
- served replies: 1e-4 absolute (the reference test's), against
  outputs of the scaled tanh (|y| < 1.72).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.backends import XLADevice
from znicz_tpu.export import ExportedModel as RefExportedModel
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.samples import imagenet_ae as ref_imagenet_ae
from znicz_tpu.models.samples import mnist_ae as ref_mnist_ae
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu.utils.snapshotter import Snapshotter as RefSnapshotter
from znicz_tpu_torch.export import ExportedModel, params_from_jax, read_bundle
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.samples import imagenet_ae, mnist_ae
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root
from znicz_tpu_torch.utils.snapshotter import Snapshotter

SEED = 5
TOL = {"float32": 1e-5, "bfloat16": 1e-4}
GD = {"learning_rate": 0.005, "gradient_moment": 0.9}


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    ref_root.common.engine.anomaly_guard = False  # the port has none
    yield
    reset_root()
    ref_root.common.precision_type = "float32"


def _tiny_data():
    rng = np.random.default_rng(3)
    # a low-rank structured signal: surely compressible
    basis = rng.normal(size=(4, 12, 12, 1)).astype(np.float32)
    coef = rng.normal(size=(60, 4)).astype(np.float32)
    return np.einsum("nk,khwc->nhwc", coef, basis) * 0.2


def _tiny_layers(tied_weights):
    return [
        {"type": "conv_tanh",
         "->": {"n_kernels": 6, "kx": 3, "ky": 3, "sliding": (1, 1)},
         "<-": GD},                                                  # 0
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},           # 1
        {"type": "depooling", "tied_to": 1},                         # 2
        {"type": "deconv_tanh", "tied_to": 0, "<-": GD,
         "tied_weights": tied_weights},                              # 3
    ]


def _tiny(cls, loader_cls, tied_weights, seed=SEED, **kwargs):
    x = _tiny_data()
    wf = cls(name="tiny_conv_ae",
             loader_factory=lambda w: loader_cls(
                 w, train_data=x[:48], valid_data=x[48:], minibatch_size=12),
             layers=_tiny_layers(tied_weights), loss="mse",
             decision_config={"max_epochs": 2}, **kwargs)
    wf._max_fires = 10 ** 6
    return wf


def _ref_tiny(tied_weights, dtype="float32", seed=SEED):
    ref_root.common.precision_type = dtype
    ref_prng.seed_all(seed)
    wf = _tiny(RefWorkflow, RefLoader, tied_weights)
    wf.initialize(device=XLADevice())
    return wf


def _port_tiny(tied_weights, dtype="float32", seed=SEED, device="cpu",
               **kwargs):
    root.common.precision_type = dtype
    prng.seed_all(seed)
    wf = _tiny(StandardWorkflow, ArrayLoader, tied_weights, **kwargs)
    wf.initialize(device=device)
    return wf


def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()


_ATTRS = ("weights", "bias", "accumulated_gradient_weights",
          "accumulated_gradient_bias")


def _ref_params(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _ATTRS:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.array(vec.mem, np.float32)
    return out


def _port_params(wf) -> dict:
    return {f"{u.name}.{name}": t.detach().float().numpy().copy()
            for u in [*wf.forwards, *wf.gds]
            for name, t in [*u.named_parameters(recurse=False),
                            *u.named_buffers(recurse=False)]}


def _assert_close(got, want, dtype="float32"):
    assert set(got) == set(want)
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[key] - w).max())
        assert err <= TOL[dtype] * scale, \
            f"{key}: {err} > {TOL[dtype]}·{scale}"


def _assert_tied(port, tied_weights):
    conv, deconv = port.forwards[0], port.forwards[3]
    assert (deconv.weights is conv.weights) == tied_weights
    assert ("weights" in dict(deconv.named_parameters())) != tied_weights
    if tied_weights:
        assert deconv.weights.data_ptr() == conv.weights.data_ptr()


_REF_RUN = """
import pickle, sys
import test_torch_autoencoders as t
pickle.dump(t._ref_tiny_steps(sys.argv[1], sys.argv[2] == "1", 10),
            open(sys.argv[3], "wb"))
"""


def _ref_tiny_steps(dtype, tied_weights, n):
    """The reference's tiny AE: ``(minibatch class, tensors, MSE by
    class)`` after each of ``n`` steps."""
    ref = _ref_tiny(tied_weights, dtype)
    steps = []
    for _ in range(n):
        _ref_step(ref)
        steps.append((ref.loader.minibatch_class, _ref_params(ref),
                      [list(h) for h in ref.decision.epoch_mse_history]))
    return steps


def _ref_tiny_steps_without_excess_precision(dtype, tied_weights, tmp_path):
    out = tmp_path / "reference_steps.pkl"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_allow_excess_precision=false"]).strip(),
        PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests),
                                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REF_RUN, dtype,
                    "1" if tied_weights else "0", str(out)],
                   check=True, env=env, timeout=300)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied_weights", [False, True])
def test_tiny_conv_ae_trains_with_the_reference(tied_weights, dtype,
                                                tmp_path):
    """Two epochs (validation, then 4 train steps, twice) from one seed,
    every tensor after every step; the MSE by epoch."""
    if dtype == "float32":
        steps = _ref_tiny_steps(dtype, tied_weights, 10)
    else:
        steps = _ref_tiny_steps_without_excess_precision(dtype, tied_weights,
                                                         tmp_path)
    port = _port_tiny(tied_weights, dtype)
    _assert_tied(port, tied_weights)
    assert [u.name for u in port.forwards] == [
        "ConvTanh", "MaxPooling", "Depooling", "DeconvTanh"]
    classes = []
    for cls, want, history in steps:
        port.step()
        classes.append(port.loader.minibatch_class)
        assert port.loader.minibatch_class == cls
        _assert_close(_port_params(port), want, dtype)
    assert classes == [VALID] + [TRAIN] * 4 + [VALID] + [TRAIN] * 4
    got = port.decision.epoch_mse_history
    for h_got, h_want in zip(got, history):
        np.testing.assert_allclose(h_got, h_want, rtol=TOL[dtype] * 10)
    _assert_tied(port, tied_weights)
    # the decoder gives back the input's geometry
    assert tuple(port.forwards[-1].output.shape[1:]) == (12, 12, 1)
    assert tuple(port.forwards[0].weights.shape) == (3, 3, 1, 6)


def test_tied_weights_stay_one_tensor_through_a_snapshot(tmp_path):
    """A tied snapshot holds the weights once (the conv's); loaded into
    a fresh port workflow, the deconv still reads the conv's tensor
    itself, and the resumed run continues bit-equal."""
    port = _port_tiny(True)
    for _ in range(6):
        port.step()
    state = port.state_dict()
    units = state["__units__"]
    assert "DeconvTanh" not in units and "weights" in units["ConvTanh"]
    assert "accumulated_gradient_weights" in units["GDDeconv"]
    resumed = _port_tiny(True, seed=9)
    resumed.load_state(state)
    _assert_tied(resumed, True)
    for _ in range(3):
        port.step()
        resumed.step()
    _assert_tied(resumed, True)
    want, got = _port_params(port), _port_params(resumed)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_a_tied_reference_snapshot_resumes_in_the_port(tmp_path):
    ref = _ref_tiny(True)
    for _ in range(6):
        _ref_step(ref)
    path = RefSnapshotter.write(ref.state_dict(), str(tmp_path), "ref", "a")
    port = _port_tiny(True, seed=3)
    port.load_state(Snapshotter.load(path))
    _assert_tied(port, True)
    _assert_close(_port_params(port), _ref_params(ref))
    for _ in range(3):
        _ref_step(ref)
        port.step()
        _assert_close(_port_params(port), _ref_params(ref))
    _assert_tied(port, True)


def test_a_tied_port_snapshot_resumes_in_the_reference(tmp_path):
    port = _port_tiny(True, snapshotter_config={
        "prefix": "port", "directory": str(tmp_path)})
    for _ in range(6):
        port.step()
    port.snapshotter.run()
    ref = _ref_tiny(True, seed=4)
    ref.load_state(RefSnapshotter.load(port.snapshotter.destination))
    assert ref.forwards[3].weights is ref.forwards[0].weights
    _assert_close(_ref_params(ref), _port_params(port))
    for _ in range(3):
        _ref_step(ref)
        port.step()
        _assert_close(_port_params(port), _ref_params(ref))


def test_run_chunked_is_bit_equal_to_run():
    straight = _port_tiny(True)
    straight.run()
    chunked = _port_tiny(True)
    chunked.run_chunked(4)
    assert straight.decision.complete and chunked.decision.complete
    want, got = _port_params(straight), _port_params(chunked)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert chunked.decision.epoch_mse_history == \
        straight.decision.epoch_mse_history
    _assert_tied(chunked, True)


def test_tied_to_rejects_bad_layer_type():
    """C13: the reference refuses ``tied_to`` on a layer that is not a
    deconv or a depooling; so does the port."""
    with pytest.raises(ValueError, match="'all2all' does not support "
                                         "tied_to"):
        StandardWorkflow(
            name="bad",
            loader_factory=lambda w: ArrayLoader(
                w, train_data=np.zeros((8, 4), dtype=np.float32),
                minibatch_size=4),
            layers=[
                {"type": "all2all", "->": {"output_sample_shape": 4}},
                {"type": "all2all", "->": {"output_sample_shape": 4},
                 "tied_to": 0},
            ],
            loss="mse")


def _pair(ref_module, port_module, **kwargs):
    ref_prng.seed_all(SEED)
    ref = ref_module.build(**kwargs)
    ref.initialize(device=XLADevice())
    prng.seed_all(SEED)
    port = port_module.build(**kwargs)
    port.initialize(device="cpu")
    return ref, port


@pytest.mark.parametrize("name", ["mnist_ae", "imagenet_ae"])
def test_sample_matches_the_reference(name):
    """The sample's defaults and layers are the reference's; at the
    reference test's reduced sizes its steps (the test and validation
    minibatches, then train steps; each from the reference's state, as
    the MNIST-784 autoencoder's test holds it) match the reference's
    and the decoder restores the input geometry."""
    if name == "mnist_ae":
        mods = (ref_mnist_ae, mnist_ae)
        kwargs = dict(n_train_samples=300, max_epochs=2, minibatch_size=30)
        shape, steps = (28, 28, 1), 12  # 2 test, 1 validation, 9 train
    else:
        mods = (ref_imagenet_ae, imagenet_ae)
        kwargs = dict(image_size=40, kx=4, ky=4, sliding=(2, 2),
                      n_kernels=4, n_train_samples=32, n_valid_samples=8,
                      minibatch_size=8, max_epochs=1)
        shape, steps = (40, 40, 3), 5
    assert dict(getattr(root, name).as_dict()) == dict(
        getattr(ref_root, name).as_dict())
    ref, port = _pair(*mods, **kwargs)
    assert [s for s in port.layers_config] == [s for s in ref.layers_config]
    _assert_close(_port_params(port), _ref_params(ref))
    for _ in range(steps):
        port.load_state(ref.state_dict())
        _ref_step(ref)
        port.step()
        _assert_close(_port_params(port), _ref_params(ref))
    assert tuple(port.forwards[-1].output.shape[1:]) == shape
    assert port.decision.min_validation_mse is not None


def _export_pair(tmp_path, tied_weights):
    """The tiny AE trained by each package and exported: ``(reference
    bundle, port bundle)``."""
    ref = _ref_tiny(tied_weights)
    ref.run()
    ref_path = str(tmp_path / "ref.npz")
    ref.export_forward(ref_path)
    port = _port_tiny(tied_weights)
    port.run()
    port_path = str(tmp_path / "port.npz")
    port.export_forward(port_path)
    return ref_path, port_path


@pytest.mark.parametrize("tied_weights", [False, True])
def test_ae_bundles_serve_both_ways(tmp_path, tied_weights):
    """Each package's AE bundle: the port writes the reference's
    manifest (the ties included) and parameter keys; the port serves
    either bundle with its ties, the tied deconv holding the conv's
    tensor, and its replies are the reference's within 1e-4."""
    ref_path, port_path = _export_pair(tmp_path, tied_weights)
    ref_manifest, ref_params = read_bundle(ref_path)
    port_manifest, port_params = read_bundle(port_path)
    assert port_manifest == ref_manifest
    assert sorted(port_params) == sorted(ref_params)
    assert ref_manifest["layers"][3]["tied_to"] == 0
    assert ref_manifest["layers"][3]["tied_weights"] is tied_weights
    carried = params_from_jax(ref_manifest, ref_params)
    for key, value in ref_params.items():
        np.testing.assert_array_equal(carried[key].numpy(), value)
    x = _tiny_data()[:5]
    for path in (ref_path, port_path):
        want = RefExportedModel.load(path, device=XLADevice())(x)
        model = ExportedModel.load(path, device="cpu")
        assert (model.forwards[3].weights is model.forwards[0].weights) \
            == tied_weights
        got = model(x)
        assert got.shape == (5, 12, 12, 1)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        oracle = RefExportedModel.load(path, device=RefNumpyDevice())(x)
        np.testing.assert_allclose(got, oracle, atol=1e-4, rtol=0)
    # the port's engine serves the port's bundle: ragged rows, one program
    # a bucket, each reply the model's own
    from znicz_tpu_torch.serving import ServingEngine
    rows = _tiny_data()[:16]
    want = ExportedModel.load(port_path, device="cpu")(rows)
    with ServingEngine(port_path, max_batch=16, device="cpu") as eng:
        for n in (1, 3, 16):
            np.testing.assert_allclose(eng(rows[:n], timeout=60), want[:n],
                                       atol=1e-6, rtol=0)


NUMPY_CLI = {
    "mnist_ae": ["mnist_ae.n_train_samples=200", "mnist_ae.max_epochs=2",
                 "mnist_ae.minibatch_size=20"],
    # the pooling's last window cut (19 → 10); the sample's rate, at
    # which its noise frames' MSE rises, cut to one that falls
    "imagenet_ae": ["imagenet_ae.image_size=40", "imagenet_ae.kx=4",
                    "imagenet_ae.ky=4", "imagenet_ae.sliding=(2, 2)",
                    "imagenet_ae.n_kernels=4",
                    "imagenet_ae.n_train_samples=32",
                    "imagenet_ae.n_valid_samples=8",
                    "imagenet_ae.minibatch_size=8",
                    "imagenet_ae.max_epochs=2",
                    "imagenet_ae.learning_rate=5e-05"],
}


@pytest.mark.parametrize("name", sorted(NUMPY_CLI))
def test_cli_trains_on_the_numpy_oracle(name):
    """``python -m znicz_tpu_torch <sample> -b numpy`` trains each
    autoencoder on the oracle (no region), and its MSE falls."""
    from znicz_tpu_torch.__main__ import Main
    main = Main()
    args = [name, "-b", "numpy"]
    for leaf in NUMPY_CLI[name]:
        args += ["--root", leaf]
    assert main.run(args) == 0
    wf = main.launcher.workflow
    assert wf.device.is_host_only and wf.region is None
    history = wf.decision.epoch_mse_history[VALID]
    assert len(history) == 2 and history[-1] < history[0]
    assert isinstance(wf.forwards[3].weights, torch.Tensor)
