"""The port's standalone activation units against the reference, on the
CPU.

Each of the six pairs (tanh, smooth RELU, strict RELU, sigmoid, log and
the constant ``mul``) runs forward and backward on the same seeded
inputs through the reference's ``numpy_run`` and ``xla_run`` (the
templates of ``tests/test_activation.py``) and through the port's units
called as modules.  Tolerance: 1e-5 relative plus 1e-6 absolute, the
bar the reference holds its two backends to (f32 elementwise math in
another order of operations: ``exp``/``tanh``/``log`` of other
libraries).  Then a workflow with activation layers between
fully-connected ones trains three steps in both packages from one
state, each tensor within 1e-5 of its largest |value|.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.memory import Vector
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.ops import activation as ref_act
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops import activation
from znicz_tpu_torch.ops.nn_units import WeightlessGradientUnit, gd_for
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root

NAMES = ("Tanh", "RELU", "StrictRELU", "Sigmoid", "Log", "Mul")
TYPES = {"Tanh": "activation_tanh", "RELU": "activation_relu",
         "StrictRELU": "activation_str", "Sigmoid": "activation_sigmoid",
         "Log": "activation_log", "Mul": "activation_mul"}
RNG = np.random.default_rng(51)
X = RNG.normal(size=(6, 9)).astype(np.float32)
ERR = RNG.normal(size=(6, 9)).astype(np.float32)
FACTOR = 2.5


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _kwargs(name):
    return {"factor": FACTOR} if name == "Mul" else {}


def _reference(name, device):
    """The reference's pair on ``device``: (y, err_input)."""
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(X.copy(), name="x"))
    fwd = getattr(ref_act, f"Forward{name}")(wf, **_kwargs(name))
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=device)
    err_src = DummyUnit(wf, err=Vector(ERR.copy(), name="err"))
    bwd = getattr(ref_act, f"Backward{name}")(wf)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output")
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=device)
    fwd.run()
    bwd.run()
    fwd.output.map_read()
    bwd.err_input.map_read()
    return fwd.output.mem.copy(), bwd.err_input.mem.copy()


def _port(name):
    fwd = getattr(activation, f"Forward{name}")((9,), torch.float32,
                                                **_kwargs(name))
    fwd.init_params("cpu")
    bwd = gd_for(type(fwd))(fwd)
    x = torch.from_numpy(X)
    y = fwd(x)
    return y.numpy(), bwd.run(x, torch.from_numpy(ERR), y).numpy()


@pytest.mark.parametrize("backend", ["numpy_run", "xla_run"])
@pytest.mark.parametrize("name", NAMES)
def test_pair_matches_the_reference(name, backend):
    device = NumpyDevice() if backend == "numpy_run" else XLADevice()
    want_y, want_e = _reference(name, device)
    got_y, got_e = _port(name)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-5, atol=1e-6)
    if name == "Mul":
        np.testing.assert_allclose(got_y, X * FACTOR, rtol=1e-6)
        np.testing.assert_allclose(got_e, ERR * FACTOR, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_layer_types_and_pairs(name):
    cls = layer_type(TYPES[name])
    assert cls is getattr(activation, f"Forward{name}")
    gd_cls = gd_for(cls)
    assert gd_cls is getattr(activation, f"Backward{name}")
    assert issubclass(gd_cls, WeightlessGradientUnit)
    # weightless: a learning rate in the config is dropped, as in the
    # reference; the first layer's backward gives no error
    fwd = cls((9,), torch.float32, **_kwargs(name))
    fwd.init_params("cpu")
    assert not list(fwd.parameters())
    bwd = gd_cls(fwd, learning_rate=0.5, need_err_input=False)
    x = torch.from_numpy(X)
    assert bwd.run(x, torch.from_numpy(ERR), fwd(x)) is None
    assert bwd.lr_state is None and not list(bwd.buffers())


def _layers():
    gd = {"learning_rate": 0.1, "gradient_moment": 0.5}
    return [{"type": "all2all", "->": {"output_sample_shape": 12},
             "<-": gd},
            {"type": "activation_log"},
            {"type": "all2all", "->": {"output_sample_shape": 10},
             "<-": gd},
            {"type": "activation_mul", "->": {"factor": 0.5}},
            {"type": "activation_sigmoid", "<-": {"learning_rate": 0.3}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": gd}]


def _data():
    rng = np.random.default_rng(8)
    return (rng.normal(size=(40, 7)).astype(np.float32),
            rng.integers(0, 3, 40).astype(np.int32))


def _loader(cls):
    x, y = _data()
    return lambda w: cls(w, train_data=x[:30], train_labels=y[:30],
                         valid_data=x[30:], valid_labels=y[30:],
                         minibatch_size=10)


def test_workflow_with_activation_layers_matches_the_reference():
    ref_root.common.engine.anomaly_guard = False
    ref_prng.seed_all(3)
    ref = RefWorkflow(name="act", loader_factory=_loader(RefLoader),
                      layers=_layers(), decision_config={"max_epochs": 9})
    ref.initialize(device=XLADevice())
    prng.seed_all(3)
    port = StandardWorkflow(name="act", loader_factory=_loader(ArrayLoader),
                            layers=_layers(),
                            decision_config={"max_epochs": 9})
    port.initialize(device="cpu")
    assert [u.name for u in port.gds] == [u.name for u in ref.gds]
    for _ in range(5):  # validation, three train steps, validation
        ref.loader._fire()
        ref._region_unit._fire()
        ref.decision._fire()
        port.step()
    for fwd, pfwd in zip(ref.forwards, port.forwards):
        for attr in ("weights", "bias"):
            vec = getattr(fwd, attr, None)
            if vec is None or not vec:
                continue
            vec.map_read()
            want = vec.mem
            got = getattr(pfwd, attr).detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
    assert port.decision.last_epoch_n_err == ref.decision.last_epoch_n_err
