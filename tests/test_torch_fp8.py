"""``root.common.engine.fp8_matmul`` on the port, on the CPU, against the
reference's fp8 ``mxu_dot`` (``jnp.dot`` of e4m3 operands with an f32
result) and its ``jax.vjp``.

- The reference's ``test_fp8_lever_default_off_and_applies``
  (``tests/test_quant.py``), ported.
- ``q8``, the port's one cast to e4m3, equal to the reference's cast to
  the bit: round to nearest even, NaN past 464 and at ±inf (464 itself
  rounds to 448), where torch's own cast saturates to ±448 (the planted
  fault below).
- On inputs drawn from multiples of 1/8 in [−4, 4] every product and
  sum is exact in f32, so the port's product and ``Fp8Dot``'s gradients
  equal the reference's and ``jax.vjp``'s to the bit: ``mxu_dot``,
  ``da = q8(g @ q8(b)ᵀ)``, ``db = q8(q8(a)ᵀ @ g)``, the overflow rows.
- The gradient round-trip before the update, and two train steps each
  of MNIST 784-100-10 and the attention stack with the lever on against
  the reference's ``xla_run``: MNIST's parameters and momentum within
  1e-5 of each tensor's largest |value|.  In the attention stack the
  flash core's f32 sums run in another order than the reference's, and
  a gradient element that lands next to an e4m3 rounding boundary then
  rounds to the neighbouring value on its round-trip, one e4m3 step
  (2⁻³ of it at most) away: so there an element may pass the 1e-5 bar,
  but only within 2⁻² of the reference's change of that element over
  the steps (two updates, each off by at most 2⁻³).  Measured: 3 of the
  48 elements of the QKV bias, each off by one e4m3 step of its
  gradient, 5.5% of its change; every other tensor within 1e-5.
- The lever is part of the region's key: flipping it captures again.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.accelerated_units import AcceleratedUnit as RefUnit
from znicz_tpu.backends import XLADevice
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.samples import mnist as ref_mnist
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.accelerated_units import AcceleratedUnit, JitRegion
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.samples import mnist
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops import fp8
from znicz_tpu_torch.ops.all2all import All2AllTanh
from znicz_tpu_torch.ops.fp8 import FP8, Fp8Dot, q8
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

#: parameters and momentum, relative to the tensor's largest |value|
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    ref_root.common.engine.anomaly_guard = False  # the port has none
    yield
    reset_root()
    ref_root.common.engine.fp8_matmul = False


def _both_on():
    root.common.engine.fp8_matmul = True
    ref_root.common.engine.fp8_matmul = True


def test_fp8_lever_default_off_and_applies():
    unit = AcceleratedUnit(None, name="fp8_probe")
    assert not root.common.engine.get("fp8_matmul", False)
    assert not fp8.fp8_enabled()  # default OFF
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    base = unit.mxu_dot(a, b).numpy()
    root.common.engine.fp8_matmul = True
    got = unit.mxu_dot(a, b)
    assert got.dtype == torch.float32  # the product's result is f32
    # fp8 arithmetic is coarse but must track the f32 product
    assert np.abs(got.numpy() - base).max() < 0.5
    assert not np.allclose(got.numpy(), base)  # the cast happened


def _ref_q8(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn).astype(
        jnp.float32))


OVERFLOW = np.float32([463.9, -463.9, 464.0, -464.0, 464.1, -464.1, np.inf,
                       -np.inf, np.nan, 448.0, -448.0, 449.0, 0.0, -0.0,
                       2.0 ** -9, 2.0 ** -10, 3.0 * 2.0 ** -10, 1e-30])


def test_q8_is_the_references_cast():
    rng = np.random.default_rng(1)
    x = np.concatenate([OVERFLOW, (rng.normal(size=4096)
                                   * np.exp2(rng.integers(-12, 9, 4096))
                                   ).astype(np.float32)])
    got = q8(torch.from_numpy(x)).float().numpy()
    want = _ref_q8(x)
    np.testing.assert_array_equal(got, want)  # NaNs where the other's
    assert np.isnan(got[4:9]).all() and got[2] == 448.0 and got[3] == -448.0
    assert q8(torch.from_numpy(x)).dtype == FP8
    # bf16 operands take the same cast
    xb = torch.from_numpy(x).bfloat16()
    np.testing.assert_array_equal(q8(xb).float().numpy(),
                                  _ref_q8(xb.float().numpy()))


def test_the_saturating_cast_fails_the_overflow_case():
    """The planted fault: a cast that saturates to ±448, inf included
    (torch's own ``.to(float8_e4m3fn)`` in the CPU tests' build; other
    builds give NaN for some of these), where the reference's gives
    NaN: the overflow case tells them apart."""
    x = torch.from_numpy(OVERFLOW[:8])
    saturating = x.clamp(-448.0, 448.0).to(FP8).float().numpy()
    want = _ref_q8(OVERFLOW[:8])
    assert not np.array_equal(saturating, want, equal_nan=True)
    assert np.isfinite(saturating).all() and np.isnan(want[4:]).all()


def _grid(rng, shape):
    """Multiples of 1/8 in [−4, 4]: every e4m3 product and every f32
    sum of such products is exact."""
    return (rng.integers(-32, 33, size=shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 8, 3), (16, 32, 16), (7, 13, 5),
                                   (100, 13, 8)])
def test_product_and_gradients_equal_the_references_on_a_grid(shape):
    _both_on()
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a, b, g = _grid(rng, (m, k)), _grid(rng, (k, n)), _grid(rng, (m, n))
    ref_unit = RefUnit(None, name="ref_fp8")
    want = np.asarray(ref_unit.mxu_dot(jnp, jnp.asarray(a), jnp.asarray(b)))
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    got = AcceleratedUnit(None, name="fp8").mxu_dot(at, bt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda x, y: ref_unit.mxu_dot(jnp, x, y),
                     jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(at.grad.numpy(), np.asarray(da))
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(db))
    # the rule written out
    a8, b8 = q8(torch.from_numpy(a)).float(), q8(torch.from_numpy(b)).float()
    gt = torch.from_numpy(g)
    assert torch.equal(at.grad, q8(gt @ b8.t()).float())
    assert torch.equal(bt.grad, q8(a8.t() @ gt).float())


def test_overflow_in_the_product_and_its_gradient():
    _both_on()
    rng = np.random.default_rng(4)
    a, b, g = _grid(rng, (6, 8)), _grid(rng, (8, 4)), _grid(rng, (6, 4))
    a[1, 2], a[3, 0], b[5, 1] = 464.1, -np.inf, 463.9
    ref_unit = RefUnit(None, name="ref_fp8")
    want, vjp = jax.vjp(lambda x, y: ref_unit.mxu_dot(jnp, x, y),
                        jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g * 100))  # gradients past 464 too
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    got = Fp8Dot.apply(at, bt)
    got.backward(torch.from_numpy(g * 100))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert np.isnan(got[1].detach().numpy()).all()
    np.testing.assert_array_equal(at.grad.numpy(), np.asarray(da))
    np.testing.assert_array_equal(bt.grad.numpy(), np.asarray(db))
    assert np.isnan(at.grad.numpy()).any()


def test_bf16_operands_keep_their_dtype():
    _both_on()
    rng = np.random.default_rng(8)
    a = torch.from_numpy(_grid(rng, (5, 16))).bfloat16().requires_grad_()
    b = torch.from_numpy(_grid(rng, (16, 4))).requires_grad_()
    y = Fp8Dot.apply(a, b)
    assert y.dtype == torch.float32
    y.sum().backward()
    assert a.grad.dtype == torch.bfloat16 and b.grad.dtype == torch.float32


def test_gradient_round_trip_before_the_update():
    """With the lever on, a backward unit's update takes the gradient
    through e4m3 after the accumulation mean (the reference's
    ``_apply_param_xla``): the same update as an explicit ``q8`` of the
    gradient with the lever off."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_grid(rng, (8, 6)))
    err = torch.from_numpy(_grid(rng, (8, 4)))
    fwd = All2AllTanh((6,), output_sample_shape=4)
    fwd.init_params("cpu")
    w0 = fwd.weights.detach().clone()
    gd = gd_for(type(fwd))(fwd, learning_rate=0.01, gradient_moment=0.0)
    root.common.engine.fp8_matmul = True
    y = fwd(x)
    gd.run(x, err, y)
    got = fwd.weights.detach().clone()
    # the gradient of the explicit product, through q8 once more
    delta = err * fwd.activation.derivative(y, None)
    grad = q8(q8(x).float().t() @ q8(delta).float()).float()
    assert torch.equal(got, w0 - 0.01 * grad)


def _fake_graphs(monkeypatch):
    class Graph:
        def replay(self):
            pass

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(JitRegion, "graphed",
                        property(lambda self: self.mark is None))


def test_the_lever_is_part_of_the_key(monkeypatch):
    _fake_graphs(monkeypatch)
    wf = _mnist_pair()[1]
    region = wf.region
    wf.step()
    n = region.captures
    root.common.engine.fp8_matmul = True
    wf.step()
    assert region.captures == n + 1
    assert any("fp8_matmul" in key for key in region._cache)
    root.common.engine.fp8_matmul = False
    wf.step()
    assert region.captures == n + 1


# -- workflows against the reference's xla_run -------------------------------
def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()


_STATE = ("weights", "bias", "weights_out", "bias_out",
          "accumulated_gradient_weights", "accumulated_gradient_bias",
          "accumulated_gradient_weights_out", "accumulated_gradient_bias_out")


def _ref_state(wf):
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _STATE:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                vec.map_read()
                out[f"{unit.name}.{attr}"] = np.asarray(vec.mem, np.float32)
    return out


def _port_state(wf):
    return {f"{unit.name}.{name}": t.detach().float().numpy().copy()
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]
            if name in _STATE}


def _assert_close(port, ref, start=None):
    """Each tensor within 1e-5 of its largest |value|; with ``start``
    (the reference's state before the steps), an element past that bar
    within 2⁻² of the reference's change of it."""
    want, got = _ref_state(ref), _port_state(port)
    assert set(got) == set(want)
    for key, w in want.items():
        diff = np.abs(got[key] - w)
        bar = TOL * max(np.abs(w).max(), 1e-30)
        if start is None:
            assert diff.max() <= bar, (key, diff.max(), bar)
            continue
        off = diff > bar
        change = np.abs(w - start.get(key, np.zeros_like(w)))
        assert (diff[off] <= 0.25 * change[off]).all(), key


def _mnist_pair():
    ref_prng.seed_all(12)
    ref = ref_mnist.build()
    ref.initialize(device=XLADevice())
    prng.seed_all(12)
    port = mnist.build()
    port.initialize(device="cpu")
    return ref, port


def _steps_to_train(ref, port, n_train=2):
    seen = 0
    while seen < n_train:
        _ref_step(ref)
        port.step()
        if port.loader.minibatch_class == 2:
            seen += 1


def test_mnist_with_the_lever_matches_the_reference():
    _both_on()
    ref, port = _mnist_pair()
    _steps_to_train(ref, port)
    _assert_close(port, ref)
    ref.evaluator.epoch_n_err.map_read()
    np.testing.assert_array_equal(port.evaluator.epoch_n_err.numpy(),
                                  ref.evaluator.epoch_n_err.mem)


ATTN = [{"type": "attention", "->": {"n_heads": 2, "causal": True},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        {"type": "layer_norm", "->": {},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        {"type": "last_token", "->": {}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]


def test_attention_stack_with_the_lever_matches_the_reference():
    _both_on()
    ref_root.common.engine.pallas_interpret = True
    ref_root.common.engine.flash_attention = True
    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 8, 16)).astype(np.float32)
    y = rng.integers(0, 3, 40).astype(np.int32)

    def factory(cls):
        return lambda w: cls(w, train_data=x[16:], train_labels=y[16:],
                             valid_data=x[:16], valid_labels=y[:16],
                             minibatch_size=8)

    ref_prng.seed_all(3)
    ref = RefWorkflow(name="attn", loader_factory=factory(RefLoader),
                      layers=ATTN, decision_config={"max_epochs": 9})
    ref.initialize(device=XLADevice())
    prng.seed_all(3)
    port = StandardWorkflow(name="attn", loader_factory=factory(ArrayLoader),
                            layers=ATTN, decision_config={"max_epochs": 9})
    port.initialize(device="cpu")
    start = _ref_state(ref)
    _steps_to_train(ref, port)
    _assert_close(port, ref, start)
