"""The port's LSTM pair against the reference, on the CPU.

The same seeded input and error go through the reference's LSTM with
its numpy oracle (an explicit loop, and explicit backpropagation through
time) and its XLA path (``lax.scan``, ``jax.vjp`` of it), and through the
port's units called as modules (a loop of torch ops, autograd of a
recomputed forward).  Tolerance: 2e-4 relative plus 1e-5 absolute in
f32, the bar the reference holds its own two backends to (the same f32
formulas, ``exp``/``tanh`` of other libraries, another summation order).
In bf16 mode (each step's product of bf16-rounded operands) the port is
held to the reference's XLA path within 1e-2 of each tensor's largest
|value|: a flipped bf16 rounding of one operand moves the sums it feeds
by 2⁻⁸ relative.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.ops.lstm import GDLSTM as RefGD
from znicz_tpu.ops.lstm import LSTM as RefLSTM
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.ops import lstm
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root

B, T, F, H = 3, 6, 4, 5
GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
RNG = np.random.default_rng(29)


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _reference(device, x, err, return_sequence, lr=0.05, moment=0.9):
    """The reference's pair: initial (weights, bias), then output,
    err_input, weights and bias after one backward."""
    ref_prng.seed_all(3)
    wf = DummyWorkflow(device=device)
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    fwd = RefLSTM(wf, units=H, return_sequence=return_sequence)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=device)
    esrc = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = RefGD(wf, learning_rate=lr, gradient_moment=moment)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output", "weights", "bias")
    bwd.link_attrs(esrc, ("err_output", "err"))
    bwd.initialize(device=device)
    for vec in (fwd.weights, fwd.bias):
        vec.map_read()
    w0, b0 = np.array(fwd.weights.mem), np.array(fwd.bias.mem)
    fwd.run()
    bwd.run()
    out = []
    for vec in (fwd.output, bwd.err_input, fwd.weights, fwd.bias):
        vec.map_read()
        out.append(np.asarray(vec.mem, np.float32).copy())
    return (w0, b0), out


def _port(x, err, return_sequence, dtype=torch.float32, lr=0.05,
          moment=0.9):
    prng.seed_all(3)
    fwd = lstm.LSTM((T, F), dtype, units=H, return_sequence=return_sequence)
    fwd.init_params("cpu")
    bwd = gd_for(type(fwd))(fwd, learning_rate=lr, gradient_moment=moment)
    init = (fwd.weights.detach().numpy().copy(),
            fwd.bias.detach().numpy().copy())
    xt = torch.from_numpy(x).to(fwd.act_store_dtype)
    y = fwd(xt)
    e = bwd.run(xt, torch.from_numpy(err).to(fwd.act_store_dtype), y)
    return init, [y.float().numpy(), e.float().numpy(),
                  fwd.weights.detach().numpy().copy(),
                  fwd.bias.detach().numpy().copy()]


@pytest.mark.parametrize("backend", ["numpy_run", "xla_run"])
@pytest.mark.parametrize("return_sequence", [False, True])
def test_pair_matches_the_reference(return_sequence, backend):
    """Forward, err_input and the updated weights and bias against the
    reference's BPTT oracle (numpy_run) and its ``jax.vjp`` of the scan
    (xla_run)."""
    x = RNG.normal(size=(B, T, F)).astype(np.float32)
    err = RNG.normal(size=(B, T, H) if return_sequence
                     else (B, H)).astype(np.float32)
    device = NumpyDevice() if backend == "numpy_run" else XLADevice()
    want_init, want = _reference(device, x, err, return_sequence)
    got_init, got = _port(x, err, return_sequence)
    for a, b in zip(got_init, want_init):  # the seeded fill
        np.testing.assert_array_equal(a, b)
    for a, b, what in zip(got, want, ("output", "err_input", "weights",
                                      "bias")):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("return_sequence", [False, True])
def test_gradient_is_the_bptt_oracles(return_sequence):
    """With a learning rate of 1 and no momentum the weight change is
    the gradient: the port's autograd against the reference's explicit
    BPTT (its ``numpy_run``)."""
    x = RNG.normal(size=(B, T, F)).astype(np.float32)
    err = RNG.normal(size=(B, T, H) if return_sequence
                     else (B, H)).astype(np.float32)
    (w0, b0), want = _reference(NumpyDevice(), x, err, return_sequence,
                                lr=1.0, moment=0.0)
    _, got = _port(x, err, return_sequence, lr=1.0, moment=0.0)
    np.testing.assert_allclose(w0 - got[2], w0 - want[2], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b0 - got[3], b0 - want[3], rtol=2e-4,
                               atol=1e-5)
    assert np.abs(w0 - got[2]).max() > 1e-3  # a real gradient


def test_bf16_matches_the_references_xla_path():
    """bf16 mode: the input stored in bf16, each step's product of
    bf16-rounded operands with f32 sums, f32 carries and output.  The
    reference is given the error in f32: its ``jax.vjp`` refuses the
    bf16 error a bf16 chain hands it (ROADMAP C11), which the port takes
    in f32."""
    x = torch.from_numpy(RNG.normal(size=(B, T, F)).astype(np.float32)
                         ).bfloat16().float().numpy()
    err = RNG.normal(size=(B, H)).astype(np.float32)
    ref_root.common.precision_type = "bfloat16"
    try:
        _, want = _reference(XLADevice(), x, err, False)
    finally:
        ref_root.common.precision_type = "float32"
    _, got = _port(x, err, False, torch.bfloat16)
    for a, b, what in zip(got, want, ("output", "err_input", "weights",
                                      "bias")):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-2 * np.abs(b).max(),
                                   err_msg=what)


def test_gates_forget_bias_and_shapes():
    prng.seed_all(3)
    fwd = lstm.LSTM((T, F), units=H)
    fwd.init_params("cpu")
    assert fwd.weights.shape == (F + H, 4 * H)
    bias = fwd.bias.detach().numpy()
    np.testing.assert_array_equal(bias[H:2 * H], 1.0)  # i|f|g|o
    np.testing.assert_array_equal(np.delete(bias, np.s_[H:2 * H]), 0.0)
    assert fwd.output_shape == (H,)
    assert lstm.LSTM((T, F), units=H, return_sequence=True
                     ).output_shape == (T, H)
    assert lstm.LSTM((T, F), output_sample_shape=7).units == 7
    # the output stays f32 in bf16 mode, as the reference stores it
    fb = lstm.LSTM((T, F), torch.bfloat16, units=H)
    fb.init_params("cpu")
    assert fb(torch.zeros(2, T, F, dtype=torch.bfloat16)).dtype \
        == torch.float32
    assert layer_type("lstm") is lstm.LSTM
    with pytest.raises(ValueError, match="units"):
        lstm.LSTM((T, F))
    # one step of the cell by hand: c = σ(f)·c + σ(i)·tanh(g)
    x = torch.randn(2, F)
    h, c = torch.randn(2, H), torch.randn(2, H)
    w, b = fwd.weights.detach(), fwd.bias.detach()
    z = torch.cat([x, h], 1) @ w + b
    i, f, g, o = z.chunk(4, 1)
    want_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    got_h, got_c = fwd.step(x, h, c, w, b)
    torch.testing.assert_close(got_c, want_c)
    torch.testing.assert_close(got_h, torch.sigmoid(o) * torch.tanh(want_c))
