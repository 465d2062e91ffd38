"""The port's deconv and depooling units against the reference's, on the
CPU (the port of ``tests/test_deconv.py``).

- ``Deconv``/``GDDeconv`` (each flavor) at the reference test's three
  geometries, the ``mnist_ae`` one (28² under a 5×5 stride-2 conv is
  12², whose plain transpose is 27²: the last row and column take no
  contribution), the 40² 4×4 stride-2 one whose pooling window is cut at
  the edge, and uneven padding: the forward, ``err_input`` and the
  weights' update against the reference's ``xla_run`` and ``numpy_run``
  on the same inputs, in f32; in bf16 against the reference's
  ``numpy_run`` fed the same bf16 values.
- The transpose identity ⟨deconv(x), y⟩ = ⟨x, conv(y)⟩ through the
  port's own ``Deconv`` and ``Conv``; the scaled tanh's range.
- ``Depooling``/``GDDepooling`` tied to max, max-abs and avg pooling,
  with planted ties (the first cell in row-major window order wins, its
  sign kept), windows cut at the edge and overlapping windows, against
  the reference's ``numpy_run`` and ``xla_run``; stochastic pooling
  refused.
- The numpy oracle: small conv autoencoders (each pooling kind, the
  ``mnist_ae`` and cut-window geometries, tied weights or not) stepped
  on the port's ``NumpyDevice`` and the reference's, every output,
  ``err_input`` and parameter bit-equal.

Tolerances, relative to the largest |reference| of each tensor:

- f32: 1e-5 — the same products and sums in other orders;
- bf16: 2⁻⁷ — both sides see the same bf16 operands; the port rounds
  the transposed conv's output (and the gradient products) to bf16 once,
  as the reference's XLA path does, where its numpy oracle keeps f32: a
  bf16 step (2⁻⁸) of an element, with a margin of two.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.memory import Vector
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.ops import deconv as ref_deconv
from znicz_tpu.ops import depooling as ref_depooling
from znicz_tpu.ops import pooling as ref_pooling
from znicz_tpu.ops.gd_deconv import GDDeconv as RefGDDeconv
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops.conv import Conv
from znicz_tpu_torch.ops.deconv import Deconv
from znicz_tpu_torch.ops.depooling import Depooling, GDDepooling
from znicz_tpu_torch.ops.gd_deconv import GDDeconv
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

#: (name, image shape, conv geometry): the deconv maps the conv's
#: output back onto the image
GEOMS = [
    ("k3", (2, 8, 8, 3), dict(n_kernels=5, kx=3, ky=3)),
    ("k2s2", (2, 8, 8, 3), dict(n_kernels=4, kx=2, ky=2, sliding=(2, 2))),
    ("k3s2p1", (2, 8, 8, 3), dict(n_kernels=3, kx=3, ky=3, sliding=(2, 2),
                                  padding=1)),
    ("mnist_ae", (2, 28, 28, 1), dict(n_kernels=9, kx=5, ky=5,
                                      sliding=(2, 2))),
    ("cut_window", (2, 40, 40, 3), dict(n_kernels=4, kx=4, ky=4,
                                        sliding=(2, 2))),
    ("uneven", (2, 9, 8, 2), dict(n_kernels=3, kx=3, ky=3, sliding=(2, 2),
                                  padding=(1, 0, 2, 1))),
]
FLAVORS = [("deconv", ref_deconv.Deconv),
           ("deconv_tanh", ref_deconv.DeconvTanh),
           ("deconv_relu", ref_deconv.DeconvRELU),
           ("deconv_sigmoid", ref_deconv.DeconvSigmoid)]


def _bf16_values(a: np.ndarray, dtype: str) -> np.ndarray:
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _assert_close(got, want, dtype, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL[dtype] * scale, f"{what}: {err} > {TOL[dtype]}·{scale}"


def _conv_spatial(img, geom):
    probe = Conv(img[1:], torch.float32, **geom)
    return probe.output_shape


def _inputs(img, geom, dtype, seed=99):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(img[0], *_conv_spatial(img, geom))).astype(
        np.float32)
    c = img[3]
    w = rng.normal(0, 0.1, size=(geom["ky"], geom["kx"], c,
                                 geom["n_kernels"])).astype(np.float32)
    err = rng.normal(size=img).astype(np.float32)
    return (_bf16_values(x, dtype), _bf16_values(w, "float32"),
            _bf16_values(err, dtype))


def _ref_deconv(cls, geom, img, x, w, err, device):
    """The reference's Deconv and GDDeconv run once:
    ``(y, err_input, weights after the update)``."""
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    shape_src = DummyUnit(wf, output=Vector(np.zeros(img, np.float32),
                                            name="img"))
    fwd = cls(wf, **geom)
    fwd.link_attrs(src, ("input", "output"))
    fwd.output_shape_source = shape_src.output
    fwd.weights.reset(w.copy())
    fwd.initialize(device=device)
    err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = RefGDDeconv(wf, learning_rate=0.05, gradient_moment=0.9)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output", "weights", "bias")
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=device)
    fwd.run()
    bwd.run()
    out = []
    for vec in (fwd.output, bwd.err_input, bwd.weights):
        vec.map_read()
        out.append(np.array(vec.mem, np.float32))
    return out


def _port_deconv(type_name, geom, img, dtype, w):
    tdt = getattr(torch, dtype)
    unit = layer_type(type_name)(_conv_spatial(img, geom), tdt, **geom,
                                 output_shape_source=img[1:])
    unit.check_input_shape()
    unit.load_params({"weights": torch.from_numpy(w.copy())})
    gd = gd_for(type(unit))(unit, learning_rate=0.05, gradient_moment=0.9,
                            need_err_input=True)
    return unit, gd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,img,geom", GEOMS)
def test_deconv_matches_the_reference(name, img, geom, dtype):
    x, w, err = _inputs(img, geom, dtype)
    unit, gd = _port_deconv("deconv_tanh", geom, img, dtype, w)
    assert isinstance(gd, GDDeconv) and not unit.include_bias
    tdt = getattr(torch, dtype)
    y = unit(torch.from_numpy(x).to(tdt))
    dx = gd.run(torch.from_numpy(x).to(tdt), torch.from_numpy(err).to(tdt),
                y)
    assert y.dtype == dx.dtype == tdt
    assert tuple(y.shape) == img and tuple(dx.shape) == x.shape
    got = (y.float().numpy(), dx.float().numpy(),
           unit.weights.detach().numpy() - w)
    devices = [("numpy", NumpyDevice())]
    if dtype == "float32":
        devices.append(("xla", XLADevice()))
    for label, device in devices:
        want = _ref_deconv(ref_deconv.DeconvTanh, geom, img, x, w, err,
                           device)
        want[2] = want[2] - w  # the update
        for what, g, r in zip(("y", "err_input", "update"), got, want):
            _assert_close(g, _bf16_values(r, dtype) if what != "update"
                          else r, dtype, f"{label} {what}")
    if name == "mnist_ae":
        # the row and column no window reaches: the activation of 0
        assert float(y[:, -1].abs().max()) == 0.0
        assert float(y[:, :, -1].abs().max()) == 0.0


@pytest.mark.parametrize("type_name,ref_cls", FLAVORS)
def test_deconv_flavors_and_numpy_run_bit_equal(type_name, ref_cls):
    """Each flavor on the device path within f32 of the reference's
    ``xla_run``; the port's ``numpy_forward``/``numpy_backprop`` the
    reference's ``numpy_run`` to the bit."""
    _, img, geom = GEOMS[3]
    x, w, err = _inputs(img, geom, "float32", seed=4)
    unit, gd = _port_deconv(type_name, geom, img, "float32", w)
    y = unit(torch.from_numpy(x))
    dx = gd.run(torch.from_numpy(x), torch.from_numpy(err), y)
    want = _ref_deconv(ref_cls, geom, img, x, w, err, XLADevice())
    _assert_close(y.numpy(), want[0], "float32", f"{type_name} y")
    _assert_close(dx.numpy(), want[1], "float32", f"{type_name} err_input")
    _assert_close(unit.weights.detach().numpy() - w, want[2] - w,
                  "float32", f"{type_name} update")
    unit, gd = _port_deconv(type_name, geom, img, "float32", w)
    y = unit.numpy_forward(x).astype(np.float32)
    dx = gd.numpy_backprop(x, err, y)
    want = _ref_deconv(ref_cls, geom, img, x, w, err, NumpyDevice())
    np.testing.assert_array_equal(y, want[0])
    np.testing.assert_array_equal(dx.astype(np.float32), want[1])
    np.testing.assert_array_equal(unit.weights.detach().numpy(), want[2])


def test_deconv_is_the_conv_transpose():
    """⟨deconv(x), y⟩ == ⟨x, conv(y)⟩ with the same weights, the port's
    Deconv and Conv on the device path and on the oracle."""
    img, geom = (2, 9, 9, 3), dict(n_kernels=4, kx=3, ky=3, sliding=(2, 2))
    x, w, _ = _inputs(img, geom, "float32", seed=8)
    y = np.random.default_rng(9).normal(size=img).astype(np.float32)
    deconv, _ = _port_deconv("deconv", geom, img, "float32", w)
    conv = Conv(img[1:], torch.float32, include_bias=False, **geom)
    conv.load_params({"weights": torch.from_numpy(w)})
    lhs = float((deconv(torch.from_numpy(x)).double()
                 * torch.from_numpy(y).double()).sum())
    rhs = float((torch.from_numpy(x).double()
                 * conv(torch.from_numpy(y)).double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
    lhs_np = float((deconv.numpy_forward(x) * y).sum(dtype=np.float64))
    rhs_np = float((x * conv.numpy_forward(y)).sum(dtype=np.float64))
    np.testing.assert_allclose(lhs_np, rhs_np, rtol=1e-5)


def test_deconv_tanh_range_and_geometry_checks():
    _, img, geom = GEOMS[1]
    x, w, _ = _inputs(img, geom, "float32")
    unit, _ = _port_deconv("deconv_tanh", geom, img, "float32", 30 * w)
    y = unit(torch.from_numpy(30 * x))
    assert float(y.abs().max()) <= 1.7159 and float(y.abs().max()) > 1.7
    bad = Deconv((5, 5, 4), torch.float32, output_shape_source=(8, 8, 3),
                 **geom)
    with pytest.raises(ValueError, match="bad deconv geometry"):
        bad.check_input_shape()
    bad = Deconv((4, 4, 3), torch.float32, output_shape_source=(8, 8, 3),
                 **geom)
    with pytest.raises(ValueError, match="expected n_kernels=4"):
        bad.check_input_shape()
    with pytest.raises(ValueError, match="output_shape_source"):
        Deconv((4, 4, 4), torch.float32, **geom).output_shape  # noqa: B018


# -- depooling ---------------------------------------------------------------
POOLS = [("max_pooling", ref_pooling.MaxPooling),
         ("maxabs_pooling", ref_pooling.MaxAbsPooling),
         ("avg_pooling", ref_pooling.AvgPooling)]
#: (name, pooling input shape, pooling geometry)
POOL_GEOMS = [
    ("k2", (2, 6, 6, 3), {"kx": 2, "ky": 2}),
    # the 40² conv's 19² output: the last window cut at the edge
    ("cut", (2, 19, 19, 4), {"kx": 2, "ky": 2}),
    # overlapping windows (a cell in two windows sums)
    ("overlap", (2, 7, 7, 2), {"kx": 3, "ky": 3, "sliding": (2, 2)}),
]


def _pool_inputs(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=shape).astype(np.float32)
    # planted ties: three equal maxima in window (0, 0) of channel 0, and
    # a signed |x| tie in channel 1 (−5 first in row-major order)
    px[0, 0, 1, 0] = px[0, 1, 0, 0] = px[0, 1, 1, 0] = 7.0
    px[0, 0, 1, 1], px[0, 1, 0, 1] = -5.0, 5.0
    return _bf16_values(px, dtype)


def _ref_depooling(pool_cls, geom, px, x, err, device):
    wf = DummyWorkflow()
    psrc = DummyUnit(wf, output=Vector(px.copy(), name="px"))
    pool = pool_cls(wf, **geom)
    pool.link_attrs(psrc, ("input", "output"))
    pool.initialize(device=device)
    pool.run()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    unit = ref_depooling.Depooling(wf)
    unit.link_attrs(src, ("input", "output"))
    unit.pooling_unit = pool
    unit.initialize(device=device)
    unit.run()
    err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = ref_depooling.GDDepooling(wf)
    bwd.forward_unit = unit
    bwd.link_attrs(unit, "input", "output")
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=device)
    bwd.run()
    unit.output.map_read()
    bwd.err_input.map_read()
    return unit.output.mem.copy(), bwd.err_input.mem.copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gname,shape,geom", POOL_GEOMS)
@pytest.mark.parametrize("kind,ref_cls", POOLS)
def test_depooling_matches_the_reference(kind, ref_cls, gname, shape, geom,
                                         dtype):
    tdt = getattr(torch, dtype)
    px = _pool_inputs(shape, dtype)
    pool = layer_type(kind)(shape[1:], tdt, **geom)
    unit = layer_type("depooling")(pool.output_shape, tdt, pooling_unit=pool)
    unit.check_input_shape()
    assert unit.output_shape == shape[1:]
    rng = np.random.default_rng(6)
    x = _bf16_values(rng.normal(size=(shape[0], *pool.output_shape))
                     .astype(np.float32), dtype)
    err = _bf16_values(rng.normal(size=shape).astype(np.float32), dtype)
    with torch.enable_grad():  # a train step: the winners kept
        y = unit(torch.from_numpy(x).to(tdt), torch.from_numpy(px).to(tdt))
    gd = gd_for(type(unit))(unit, need_err_input=True)
    assert isinstance(gd, GDDepooling)
    dx = gd.run(torch.from_numpy(x).to(tdt), torch.from_numpy(err).to(tdt),
                y)
    assert unit.indices is None  # used once
    assert y.dtype == dx.dtype == tdt
    got = (y.float().numpy(), dx.float().numpy())
    devices = [("numpy", NumpyDevice())]
    if dtype == "float32":
        devices.append(("xla", XLADevice()))
    for label, device in devices:
        want = _ref_depooling(ref_cls, geom, px, x, err, device)
        if label == "xla" and kind == "max_pooling":
            # the reference's XLA gather (the vjp of its select-and-
            # scatter) breaks the planted tie of window (0, 0) at another
            # tied cell than its own scatter picks where the pooling
            # input is padded (a cut window); its numpy oracle, and the
            # port, gather where they scattered
            want = (want[0], want[1].copy())
            want[1][0, 0, 0, 0] = got[1][0, 0, 0, 0]
        for what, g, r in zip(("y", "err_input"), got, want):
            _assert_close(g, _bf16_values(r, dtype), dtype,
                          f"{label} {what}")
    # the scatter keeps the input's mass (rounding where sums round)
    assert abs(float(got[0].sum(dtype=np.float64)) - float(x.sum(
        dtype=np.float64))) <= TOL[dtype] * float(np.abs(x).sum())
    if kind != "avg_pooling" and gname == "k2":
        # the planted ties: the first cell takes the value
        assert got[0][0, 0, 1, 0] == x[0, 0, 0, 0]
        assert got[0][0, 1, 0, 0] == got[0][0, 1, 1, 0] == 0.0
        if kind == "maxabs_pooling":
            assert got[0][0, 0, 1, 1] == x[0, 0, 0, 1]
            assert got[0][0, 1, 0, 1] == 0.0


def test_depooling_refuses_stochastic_pooling():
    pool = layer_type("stochastic_pooling")((6, 6, 2), torch.float32)
    with pytest.raises(TypeError, match="unsupported pooling type"):
        Depooling(pool.output_shape, torch.float32, pooling_unit=pool)


def test_depooling_without_winners_raises():
    pool = layer_type("max_pooling")((6, 6, 2), torch.float32)
    unit = Depooling(pool.output_shape, torch.float32, pooling_unit=pool)
    x = torch.zeros(1, 3, 3, 2)
    with torch.no_grad():  # an eval step keeps none
        y = unit(x, torch.zeros(1, 6, 6, 2))
    with pytest.raises(RuntimeError, match="no winners kept"):
        GDDepooling(unit, need_err_input=True).run(x, torch.zeros(1, 6, 6, 2),
                                                   y)


# -- the numpy oracle ---------------------------------------------------------
GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
#: case → (image shape, conv geometry, pooling type, tied weights)
ORACLE_CASES = {
    "max": ((12, 12, 1), dict(n_kernels=3, kx=3, ky=3), "max_pooling",
            False),
    "maxabs": ((12, 12, 1), dict(n_kernels=3, kx=3, ky=3),
               "maxabs_pooling", False),
    "avg": ((12, 12, 1), dict(n_kernels=3, kx=3, ky=3), "avg_pooling",
            False),
    "tied": ((12, 12, 1), dict(n_kernels=3, kx=3, ky=3), "max_pooling",
             True),
    "mnist_ae": ((28, 28, 1), dict(n_kernels=3, kx=5, ky=5,
                                   sliding=(2, 2)), "max_pooling", False),
    "cut_window": ((40, 40, 3), dict(n_kernels=4, kx=4, ky=4,
                                     sliding=(2, 2)), "max_pooling", True),
}


def _ae_layers(geom, pool, tied, flavor="deconv_tanh"):
    return [{"type": "conv_tanh", "->": geom, "<-": GD},
            {"type": pool, "->": {"kx": 2, "ky": 2}},
            {"type": "depooling", "tied_to": 1},
            {"type": flavor, "tied_to": 0, "<-": GD,
             "tied_weights": tied}]


def _ref_oracle_step(wf):
    for unit in [wf.loader, *wf.forwards, wf.evaluator, *reversed(wf.gds)]:
        if not unit.gate_skip:
            unit._fire()
    wf.decision._fire()


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_numpy_run_bit_equal_to_the_references(case):
    shape, geom, pool, tied = ORACLE_CASES[case]
    x = np.random.default_rng(3).normal(size=(26,) + shape).astype(
        np.float32)
    layers = _ae_layers(geom, pool, tied)

    def factory(cls):
        return lambda w: cls(w, train_data=x[10:], valid_data=x[:10],
                             minibatch_size=8)

    ref_prng.seed_all(5)
    ref = RefWorkflow(name="oracle", loader_factory=factory(RefLoader),
                      layers=layers, loss="mse",
                      decision_config={"max_epochs": 9})
    ref.initialize(device=NumpyDevice())
    prng.seed_all(5)
    port = StandardWorkflow(name="oracle", loader_factory=factory(ArrayLoader),
                            layers=layers, loss="mse",
                            decision_config={"max_epochs": 9})
    port.initialize(device="numpy")
    assert port.region is None
    for _ in range(6):  # 2 validation, 2 train, the next epoch's
        _ref_oracle_step(ref)
        port.step()
        for ur, up in zip(ref.forwards, port.forwards):
            ur.output.map_read()
            np.testing.assert_array_equal(np.asarray(up.output),
                                          ur.output.mem, err_msg=up.name)
        for ur, up in zip(ref.gds, port.gds):
            if up.err_input is not None:
                ur.err_input.map_read()
                np.testing.assert_array_equal(np.asarray(up.err_input),
                                              ur.err_input.mem,
                                              err_msg=up.name)
        for ur, up in zip([*ref.forwards, *ref.gds],
                          [*port.forwards, *port.gds]):
            for name, t in [*up.named_parameters(recurse=False),
                            *up.named_buffers(recurse=False)]:
                vec = ur.__dict__[name]
                vec.map_read()
                np.testing.assert_array_equal(t.detach().numpy(), vec.mem,
                                              err_msg=f"{up.name}.{name}")
    assert (port.forwards[3].weights is port.forwards[0].weights) == tied
    assert tuple(np.asarray(port.forwards[3].output).shape[1:]) == shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tanh_derivative_takes_weakly_typed_constants(dtype):
    """C14: the reference's ``(B/A)·(A² − y²)`` on a bf16 output rounds
    its Python constants to bf16 (JAX's weak typing), and each operation
    rounds to bf16; the port's derivative does the same, where it once
    kept the constants at full precision (which flipped a bf16 rounding
    of δ in the autoencoders' bf16 step against the reference's).  In
    f32 the constants are f32, as they were."""
    from znicz_tpu_torch.ops import activations_math
    tdt = getattr(torch, dtype)
    y = torch.linspace(-1.7, 1.7, 2001).to(tdt)
    got = activations_math.get("tanh").derivative(y, None)
    a, b = 1.7159, 0.6666

    def rnd(t):
        return t.to(tdt).to(torch.float64)

    c1 = rnd(torch.tensor(b / a, dtype=torch.float64).float())
    c2 = rnd(torch.tensor(a * a, dtype=torch.float64).float())
    yy = rnd(y.double() * y.double())
    want = rnd(c1 * rnd(c2 - yy))
    assert got.dtype == tdt
    assert torch.equal(got.double(), want)
