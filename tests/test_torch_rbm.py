"""The RBM units and the ``mnist_rbm`` sample of the port against the
reference, on the CPU (the port of ``tests/test_rbm.py``).

- ``Binarization``: samples in {0, 1} whose mean tracks each
  probability within 4σ on the CPU device (the port's 24-bit draws),
  and on the numpy oracle the reference's draws bit for bit.
- ``BatchWeights`` against the reference's ``numpy_run`` and
  ``xla_run``.
- CD-1 from an injected hidden sample (deterministic) against the
  reference's ``xla_run`` at the reference test's bar (rtol 1e-4, atol
  1e-5): the reconstruction, the weights, hbias and vbias, without and
  with momentum, over two steps; CD-2 on the numpy oracle bit-equal to
  the reference's (its extra sample drawn from the host stream in the
  same order).  An eval step leaves the parameters as they were, bit
  for bit.
- ``mnist_rbm`` through ``Main().run([... "-b", "numpy"])`` bit-equal to
  the reference's ``NumpyDevice`` run, epoch by epoch over 3 epochs
  (the validation and train MSE, the final parameters); on ``-b cpu``
  it meets the reference test's bar (best validation MSE < 0.75 × the
  first epoch's, in 15 epochs), and ``--chunk 4`` trains it the same.
"""

import numpy as np
import pytest
import torch
from torch import nn

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector as RefVector
from znicz_tpu.models.samples import mnist_rbm as ref_mnist_rbm
from znicz_tpu.ops import rbm_units as ref_rbm
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.__main__ import Main
from znicz_tpu_torch.models.samples import mnist_rbm
from znicz_tpu_torch.ops.rbm_units import (BatchWeights, Binarization,
                                           GradientRBM)
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

RNG = np.random.default_rng(11)
SEED = 1234
#: the reference test's bar between its numpy and XLA CD steps
RTOL, ATOL = 1e-4, 1e-5
#: the reference test's convergence bar: the best validation MSE of a
#: 15-epoch run under this share of the first epoch's
MSE_BAR, BAR_EPOCHS = 0.75, 15


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    ref_root.common.engine.anomaly_guard = False
    yield
    reset_root()


# -- Binarization ---------------------------------------------------------------
def test_binarization_keep_fraction_within_4_sigma():
    p = np.tile(np.linspace(0.05, 0.95, 10), (4000, 1)).astype(np.float32)
    unit = Binarization(input_shape=(10,))
    unit.initialize(device="cpu")
    unit.input = torch.from_numpy(p)
    unit.run()
    first = unit.output
    assert set(np.unique(first.numpy())) <= {0.0, 1.0}
    sigma = np.sqrt(p[0] * (1.0 - p[0]) / len(p))
    assert np.all(np.abs(first.numpy().mean(axis=0) - p[0]) < 4 * sigma)
    unit.run()  # the chain moved on: a new sample
    assert not torch.equal(first, unit.output)


def test_binarization_oracle_draws_the_references():
    p = RNG.uniform(size=(64, 12)).astype(np.float32)
    ref_prng.seed_all(SEED)
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=RefVector(p.copy(), name="p"))
    ref = ref_rbm.Binarization(wf)
    ref.link_attrs(src, ("input", "output"))
    ref.initialize(device=RefNumpyDevice())
    prng.seed_all(SEED)
    port = Binarization(input_shape=(12,))
    port.initialize(device="numpy")
    port.input = p.copy()
    for _ in range(2):
        ref.run()
        port.run()
        ref.output.map_read()
        np.testing.assert_array_equal(port.output, ref.output.mem)


# -- BatchWeights -----------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_batch_weights_against_the_reference(device):
    v = RNG.normal(size=(16, 12)).astype(np.float32)
    h = RNG.normal(size=(16, 7)).astype(np.float32)
    wf = DummyWorkflow()
    ref = ref_rbm.BatchWeights(wf)
    ref.link_attrs(DummyUnit(wf, output=RefVector(v.copy(), name="v")),
                   ("v", "output"))
    ref.link_attrs(DummyUnit(wf, output=RefVector(h.copy(), name="h")),
                   ("h", "output"))
    ref.initialize(device=RefNumpyDevice() if device == "numpy"
                   else XLADevice())
    ref.run()
    port = BatchWeights()
    port.initialize(device=device)
    port.v, port.h = ((v.copy(), h.copy()) if device == "numpy"
                      else (torch.from_numpy(v), torch.from_numpy(h)))
    port.run()
    for name in ("weights_batch", "v_mean", "h_mean"):
        vec = getattr(ref, name)
        vec.map_read()
        got = getattr(port, name)
        got = got if isinstance(got, np.ndarray) else got.numpy()
        if device == "numpy":
            np.testing.assert_array_equal(got, vec.mem)
        else:
            np.testing.assert_allclose(got, vec.mem, rtol=1e-5, atol=1e-6)


# -- GradientRBM ------------------------------------------------------------------
def _cd_inputs(n=8, nv=12, nh=6):
    v0 = (RNG.uniform(size=(n, nv)) < 0.4).astype(np.float32)
    w = RNG.normal(0, 0.1, size=(nv, nh)).astype(np.float32)
    hb = RNG.normal(0, 0.1, size=(nh,)).astype(np.float32)
    vb = RNG.normal(0, 0.1, size=(nv,)).astype(np.float32)
    h0 = (1.0 / (1.0 + np.exp(-(v0 @ w + hb)))).astype(np.float32)
    s0 = (RNG.uniform(size=h0.shape) < h0).astype(np.float32)
    return v0, h0, s0, w, hb, vb


def _ref_grbm(device, v0, h0, s0, w, hb, vb, **kwargs):
    wf = DummyWorkflow()
    unit = ref_rbm.GradientRBM(wf, learning_rate=0.1, **kwargs)
    unit.link_attrs(DummyUnit(wf, output=RefVector(v0.copy(), name="v0")),
                    ("input", "output"))
    unit.link_attrs(DummyUnit(wf, output=RefVector(h0.copy(), name="h0")),
                    ("hidden", "output"))
    unit.link_attrs(DummyUnit(wf, output=RefVector(s0.copy(), name="s0")),
                    ("hidden_sample", "output"))
    unit.link_attrs(DummyUnit(wf, w=RefVector(w.copy(), name="w"),
                              b=RefVector(hb.copy(), name="hb")),
                    ("weights", "w"), ("hbias", "b"))
    unit.vbias.reset(vb.copy())
    unit.initialize(device=device)
    return unit


def _port_grbm(device, v0, h0, s0, w, hb, vb, **kwargs):
    unit = GradientRBM(learning_rate=0.1, **kwargs)
    unit.weights = nn.Parameter(torch.from_numpy(w.copy()),
                                requires_grad=False)
    unit.hbias = nn.Parameter(torch.from_numpy(hb.copy()),
                              requires_grad=False)
    unit.vbias = torch.from_numpy(vb.copy())
    unit.initialize(device=device)
    if device == "numpy":
        unit.input, unit.hidden, unit.hidden_sample = v0, h0, s0
    else:
        unit.input, unit.hidden, unit.hidden_sample = (
            torch.from_numpy(a) for a in (v0, h0, s0))
    return unit


def _ref_values(unit):
    out = []
    for vec in (unit.reconstruction, unit.weights, unit.hbias, unit.vbias):
        vec.map_read()
        out.append(np.array(vec.mem))
    return out


def _port_values(unit):
    rec = unit.reconstruction
    rec = rec if isinstance(rec, np.ndarray) else rec.numpy()
    return [np.array(rec)] + [t.detach().numpy().copy()
                              for t in (unit.weights, unit.hbias,
                                        unit.vbias)]


@pytest.mark.parametrize("moment", [0.0, 0.9])
def test_cd1_from_an_injected_sample_against_xla_run(moment):
    """CD-1 from a fixed hidden sample is deterministic: the port's CPU
    step against the reference's ``xla_run`` over two steps, and the
    port's oracle against the reference's bit for bit."""
    inputs = _cd_inputs()
    kwargs = {"gradient_moment": moment}
    ref = _ref_grbm(XLADevice(), *inputs, **kwargs)
    port = _port_grbm("cpu", *inputs, **kwargs)
    ref_np = _ref_grbm(RefNumpyDevice(), *inputs, **kwargs)
    port_np = _port_grbm("numpy", *inputs, **kwargs)
    for _ in range(2):
        for unit in (ref, port, ref_np, port_np):
            unit.run()
        for got, want in zip(_port_values(port), _ref_values(ref)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for got, want in zip(_port_values(port_np), _ref_values(ref_np)):
            np.testing.assert_array_equal(got, want)
    # golden: the first step written out longhand
    v0, h0, s0, w, hb, vb = inputs
    v1 = 1.0 / (1.0 + np.exp(-(s0 @ w.T + vb)))
    h1 = 1.0 / (1.0 + np.exp(-(v1 @ w + hb)))
    grad_w = (v0.T @ h0 - v1.T @ h1) / len(v0)
    once = _port_grbm("cpu", *inputs)
    once.run()
    np.testing.assert_allclose(once.weights.detach().numpy(),
                               w + 0.1 * grad_w, rtol=RTOL, atol=ATOL)


def test_cd2_on_the_oracle_draws_the_references():
    inputs = _cd_inputs()
    ref_prng.seed_all(SEED)
    ref = _ref_grbm(RefNumpyDevice(), *inputs, cd_k=2, gradient_moment=0.5)
    prng.seed_all(SEED)
    port = _port_grbm("numpy", *inputs, cd_k=2, gradient_moment=0.5)
    for _ in range(3):
        ref.run()
        port.run()
        for got, want in zip(_port_values(port), _ref_values(ref)):
            np.testing.assert_array_equal(got, want)
    # and on the CPU device the extra sample is a draw of the unit's own
    # chain: two units from one seed agree, and both leave CD-1
    runs = []
    for _ in range(2):
        prng.seed_all(SEED)
        unit = _port_grbm("cpu", *inputs, cd_k=2)
        unit.sync_host_state()
        unit.run()
        runs.append(_port_values(unit))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    cd1 = _port_grbm("cpu", *inputs)
    cd1.run()
    assert not np.array_equal(runs[0][1], _port_values(cd1)[1])


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_eval_step_leaves_the_parameters(device):
    inputs = _cd_inputs(n=4, nv=6, nh=3)
    unit = _port_grbm(device, *inputs)
    unit.forward_mode = "eval"
    unit.run()
    _, w, hb, vb = _port_values(unit)
    np.testing.assert_array_equal(w, inputs[3])
    np.testing.assert_array_equal(hb, inputs[4])
    np.testing.assert_array_equal(vb, inputs[5])
    assert _port_values(unit)[0].shape == (4, 6)


# -- the sample -------------------------------------------------------------------
def _ref_sample(epochs: int):
    ref_prng.seed_all(SEED)
    wf = ref_mnist_rbm.build(max_epochs=epochs)
    wf.initialize(device=RefNumpyDevice())
    wf.run()
    return wf


def _ref_params(wf) -> dict:
    out = {}
    for name, vec in (("weights", wf.encoder.weights),
                      ("bias", wf.encoder.bias), ("vbias", wf.grbm.vbias)):
        vec.map_read()
        out[name] = np.array(vec.mem)
    return out


def _port_params(wf) -> dict:
    return {"weights": wf.encoder.weights.detach().numpy(),
            "bias": wf.encoder.bias.detach().numpy(),
            "vbias": wf.grbm.vbias.numpy()}


def test_mnist_rbm_on_the_oracle_equals_the_references():
    np.testing.assert_array_equal(mnist_rbm.make_data(),
                                  ref_mnist_rbm.make_data())
    assert dict(root.mnist_rbm.as_dict()) == \
        dict(ref_root.mnist_rbm.as_dict())
    main = Main()
    assert main.run(["mnist_rbm", "-b", "numpy", "--seed", str(SEED),
                     "--root", "mnist_rbm.max_epochs=3"]) == 0
    port = main.launcher.workflow
    assert port.region is None and port.device.is_host_only
    ref = _ref_sample(3)
    want = ref.decision.epoch_mse_history
    got = port.decision.epoch_mse_history
    assert len(got[1]) == 3 and got == want
    for name, value in _ref_params(ref).items():
        np.testing.assert_array_equal(_port_params(port)[name], value,
                                      err_msg=name)


def test_mnist_rbm_on_the_cpu_meets_the_reference_bar():
    """The reference test's bar in 15 epochs on ``-b cpu``, and the same
    run with ``--chunk 4`` (which trains such a workflow with ``run()``)
    the same to the bit."""
    runs = []
    for chunk in ([], ["--chunk", "4"]):
        main = Main()
        assert main.run(["mnist_rbm", "-b", "cpu", "--seed", str(SEED),
                         *chunk, "--root",
                         f"mnist_rbm.max_epochs={BAR_EPOCHS}"]) == 0
        wf = main.launcher.workflow
        assert wf.device.type == "cpu" and wf.decision.complete
        assert wf.region is not None and wf.region.captures == 0
        runs.append(wf)
    history = runs[0].decision.epoch_mse_history
    assert len(history[1]) == BAR_EPOCHS
    first, best = history[1][0], runs[0].decision.min_validation_mse
    assert best < MSE_BAR * first, (first, best)
    assert runs[1].decision.epoch_mse_history == history
    for name, value in _port_params(runs[0]).items():
        np.testing.assert_array_equal(_port_params(runs[1])[name], value)
