"""The port's AlexNet slice against the reference, on the CPU.

Each ported unit (conv and its activation flavors with their backward
units, max pooling and its backward, the fully connected flavors) is
held against the reference's unit on the same inputs and weights; then
the AlexNet layer sequence, cut to 35×35 inputs, narrow kernels, FC 32
and 10 classes, trains through the reference's ``StandardWorkflow`` and
through the port's ``StandardWorkflow(device="cpu")`` from the same
state (the reference's, carried over by ``load_reference_state``), step
by step across an epoch boundary.  The cut keeps every kind of layer
and ragged pooling (16→8, 8→4 and 4→2 windows that overhang the
input); the uint8 dataset is normalized in the gather, as AlexNet's.

Tolerances, relative to the largest |reference| of each tensor:

- float32: 1e-5 (summation order only);
- bf16 units: y and err_input within 2⁻⁷ (one bf16 rounding flip where
  the two sum an f32 value in another order), updates within 1e-2;
- bf16 slice: 1e-4 (measured 4e-6).  Both round at the same points
  (the loader's normalization once, as a fused multiply-add; conv
  operands and outputs; activations; δ; the LRN's f32 math on bf16
  storage), provided the reference's XLA keeps them: its CPU compiler
  by default drops a bf16 round trip (``xla_allow_excess_precision``),
  which leaves the reference's conv outputs unrounded, moves a sixth
  of them by one bf16 step and the first step's cancelling conv
  updates by up to a seventh of their largest value.  So the bf16
  reference runs in a process of its own with that flag off.  It also
  runs with ``engine.lrn_d_bf16`` off: the reference rounds the LRN
  denominator to bf16 on its XLA path, the port follows the
  reference's Pallas kernel, which does not (``tests/test_torch_lrn.py``
  holds the units with the rounding on, in the looser band it needs).

Dropout runs at ratio 0 in the slice, where the reference's mask is
all ones: its bits cannot be reproduced (``tests/test_torch_dropout.py``
holds the port's dropout to the contract instead).
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from znicz_tpu import datasets as ref_datasets
from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.memory import Vector
from znicz_tpu.models.samples import alexnet as ref_alexnet
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.ops import all2all as ref_all2all
from znicz_tpu.ops import conv as ref_conv
from znicz_tpu.ops import gd as ref_gd
from znicz_tpu.ops import gd_conv as ref_gd_conv
from znicz_tpu.ops import gd_pooling as ref_gd_pooling
from znicz_tpu.ops import pooling as ref_pooling
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.models.samples import alexnet
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

UNIT_TOL = {"float32": {"out": 1e-5, "update": 1e-5},
            "bfloat16": {"out": 2.0 ** -7, "update": 1e-2}}
SLICE_TOL = {"float32": {"weights": 1e-5, "momentum": 1e-5, "loss": 1e-5},
             "bfloat16": {"weights": 1e-4, "momentum": 1e-4, "loss": 1e-4}}
GD = {"learning_rate": 0.05, "gradient_moment": 0.9, "weights_decay": 5e-4}


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _read(vec) -> np.ndarray:
    vec.map_read()
    return np.asarray(vec.mem).astype(np.float32)


def _ref_unit_step(fwd_cls, gd_cls, x, err, dtype, fwd_kwargs, gd_kwargs):
    """One forward and backward of the reference's unit pair: ``(fwd,
    y, err_input, {param: (before, after)})``."""
    ref_root.common.precision_type = dtype
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    fwd = fwd_cls(wf, **fwd_kwargs)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=XLADevice())
    err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = gd_cls(wf, **gd_kwargs)
    bwd.forward_unit = fwd
    weighted = "weights" in fwd.__dict__ and fwd.weights
    bwd.link_attrs(fwd, "input", "output",
                   *(("weights", "bias") if weighted else ()))
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=XLADevice())
    params = {k: _read(getattr(fwd, k)) for k in ("weights", "bias")
              if weighted}
    fwd.run()
    bwd.run()
    params = {k: (v, _read(getattr(fwd, k))) for k, v in params.items()}
    return fwd, _read(fwd.output), _read(bwd.err_input), params


def _port_unit_step(type_name, x, err, dtype, fwd_kwargs, gd_kwargs,
                    params):
    tdt = getattr(torch, dtype)
    unit = layer_type(type_name)(tuple(x.shape[1:]), tdt, **fwd_kwargs)
    if params:
        unit.load_params({k: torch.from_numpy(v[0]) for k, v in
                          params.items()})
    gd = gd_for(type(unit))(unit, need_err_input=True, **gd_kwargs)
    tx = torch.from_numpy(x).to(tdt)
    with torch.enable_grad():  # a train step: pooling keeps its winners
        y = unit(tx)
    dx = gd.run(tx, torch.from_numpy(err).to(tdt), y)
    assert y.dtype == dx.dtype == tdt
    return unit, y.float().numpy(), dx.float().numpy()


def _check_unit(type_name, fwd_cls, gd_cls, x, dtype, fwd_kwargs,
                gd_kwargs=None):
    gd_kwargs = gd_kwargs or {}
    # values the bf16 activations hold, so both start from the same
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    shape_unit = layer_type(type_name)(tuple(x.shape[1:]), torch.float32,
                                       **fwd_kwargs)
    err = np.random.default_rng(7).normal(
        0, 1, (x.shape[0], *shape_unit.output_shape)).astype(np.float32)
    err = torch.from_numpy(err).to(getattr(torch, dtype)).float().numpy()
    _, want_y, want_dx, params = _ref_unit_step(
        fwd_cls, gd_cls, x, err, dtype, fwd_kwargs, gd_kwargs)
    unit, y, dx = _port_unit_step(type_name, x, err, dtype, fwd_kwargs,
                                  gd_kwargs, params)
    tol = UNIT_TOL[dtype]
    assert y.shape == want_y.shape and dx.shape == want_dx.shape
    assert _rel(y, want_y) <= tol["out"], "y"
    assert _rel(dx, want_dx) <= tol["out"], "err_input"
    for name, (before, after) in params.items():
        got = getattr(unit, name).detach().numpy() - before
        assert _rel(got, after - before) <= tol["update"], name
    return y, dx


CONV_FLAVORS = [("conv", ref_conv.Conv, ref_gd_conv.GradientDescentConv),
                ("conv_tanh", ref_conv.ConvTanh, ref_gd_conv.GDTanhConv),
                ("conv_relu", ref_conv.ConvRELU, ref_gd_conv.GDRELUConv),
                ("conv_str", ref_conv.ConvStrictRELU,
                 ref_gd_conv.GDStrictRELUConv),
                ("conv_sigmoid", ref_conv.ConvSigmoid,
                 ref_gd_conv.GDSigmoidConv)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("type_name,fwd_cls,gd_cls", CONV_FLAVORS)
def test_conv_units_match_the_reference(type_name, fwd_cls, gd_cls, dtype):
    x = np.random.default_rng(1).normal(0, 1, (3, 9, 9, 5)).astype(
        np.float32)
    geom = {"n_kernels": 6, "kx": 3, "ky": 3, "sliding": (2, 2),
            "padding": 1, "weights_stddev": 0.3, "bias_stddev": 0.2}
    _check_unit(type_name, fwd_cls, gd_cls, x, dtype, geom, GD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_with_uneven_padding_and_strides(dtype):
    """(top, bottom, left, right) padding that cuDNN's symmetric padding
    cannot take, an 11×11/4 window as AlexNet's first conv, and a
    non-square kernel with (1, 2) strides."""
    x = np.random.default_rng(2).normal(0, 1, (2, 23, 19, 3)).astype(
        np.float32)
    for geom in ({"n_kernels": 4, "kx": 11, "ky": 11, "sliding": (4, 4)},
                 {"n_kernels": 3, "kx": 2, "ky": 3, "sliding": (1, 2),
                  "padding": (1, 0, 2, 1)}):
        _check_unit("conv_str", ref_conv.ConvStrictRELU,
                    ref_gd_conv.GDStrictRELUConv, x, dtype,
                    {**geom, "weights_stddev": 0.2}, GD)


POOL_GEOMS = [
    ("alexnet", (2, 13, 13, 4), {"kx": 3, "ky": 3, "sliding": (2, 2)}),
    # the last window overhangs: ceil((8 − 3) / 2) + 1 = 4 windows
    ("ragged", (2, 8, 8, 3), {"kx": 3, "ky": 3, "sliding": (2, 2)}),
    ("window_over_input", (2, 2, 3, 3), {"kx": 3, "ky": 3}),
    ("default_sliding", (2, 7, 5, 2), {"kx": 2, "ky": 3}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,geom", POOL_GEOMS)
def test_max_pooling_matches_the_reference_on_ties(name, shape, geom,
                                                   dtype):
    """Values on a coarse grid, so most windows hold ties: the error goes
    to the first maximum, as the reference's select-and-scatter sends
    it, and sums where overlapping windows picked the same element."""
    x = np.random.default_rng(3).integers(0, 4, shape).astype(np.float32)
    y, dx = _check_unit("max_pooling", ref_pooling.MaxPooling,
                        ref_gd_pooling.GDMaxPooling, x, dtype, geom)
    assert np.count_nonzero(dx) <= np.prod(y.shape)


A2A_FLAVORS = [("all2all", ref_all2all.All2All, ref_gd.GradientDescent),
               ("all2all_tanh", ref_all2all.All2AllTanh, ref_gd.GDTanh),
               ("all2all_relu", ref_all2all.All2AllRELU, ref_gd.GDRELU),
               ("all2all_str", ref_all2all.All2AllStrictRELU,
                ref_gd.GDStrictRELU),
               ("all2all_sigmoid", ref_all2all.All2AllSigmoid,
                ref_gd.GDSigmoid)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("type_name,fwd_cls,gd_cls", A2A_FLAVORS)
def test_all2all_flavors_match_the_reference(type_name, fwd_cls, gd_cls,
                                             dtype):
    x = np.random.default_rng(4).normal(0, 1, (5, 3, 4)).astype(np.float32)
    _check_unit(type_name, fwd_cls, gd_cls, x, dtype,
                {"output_sample_shape": 7, "weights_stddev": 0.4}, GD)


# ----------------------------------------------------------------------
# the slice
# ----------------------------------------------------------------------
SIZE, CLASSES = 35, 10
N_TRAIN, N_VALID, BATCH = 24, 8, 8


def _slice_layers():
    """``alexnet.layers`` cut to size: every layer kind in AlexNet's
    order, narrow, dropout at ratio 0."""
    gd = {"learning_rate": 0.02, "gradient_moment": 0.9,
          "weights_decay": 5e-4}
    lrn = {"n": 5, "alpha": 1e-4, "beta": 0.75, "k": 2.0}
    pool = {"kx": 3, "ky": 3, "sliding": (2, 2)}

    def conv(k, kx, **geom):
        return {"type": "conv_str",
                "->": {"n_kernels": k, "kx": kx, "ky": kx,
                       "weights_stddev": 0.1, **geom}, "<-": gd}

    def fc(n, kind="all2all_str"):
        return {"type": kind, "->": {"output_sample_shape": n,
                                     "weights_stddev": 0.1}, "<-": gd}

    return [conv(8, 5, sliding=(2, 2)),              # 35 → 16
            {"type": "norm", "->": dict(lrn)},
            {"type": "max_pooling", "->": dict(pool)},  # 16 → 8
            conv(12, 3, padding=1),
            {"type": "norm", "->": dict(lrn)},
            {"type": "max_pooling", "->": dict(pool)},  # 8 → 4
            conv(16, 3, padding=1),
            conv(16, 3, padding=1),
            conv(12, 3, padding=1),
            {"type": "max_pooling", "->": dict(pool)},  # 4 → 2
            fc(32),
            {"type": "dropout", "->": {"dropout_ratio": 0.0}},
            fc(32),
            {"type": "dropout", "->": {"dropout_ratio": 0.0}},
            fc(CLASSES, "softmax")]


def _loader(cls):
    x, y = datasets.synthetic_imagenet(N_TRAIN + N_VALID, size=SIZE,
                                       n_classes=CLASSES)
    return lambda w: cls(w, train_data=x[:N_TRAIN], train_labels=y[:N_TRAIN],
                         valid_data=x[N_TRAIN:], valid_labels=y[N_TRAIN:],
                         minibatch_size=BATCH,
                         normalization_scale=2.0 / 255.0,
                         normalization_bias=-1.0)


def _reference(dtype, seed=21):
    ref_root.common.precision_type = dtype
    ref_root.common.engine.lrn_d_bf16 = False  # the Pallas kernels' d
    ref_prng.seed_all(seed)
    wf = RefWorkflow(name="torch_alexnet", loader_factory=_loader(RefLoader),
                     layers=_slice_layers(),
                     decision_config={"max_epochs": 100})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    return wf


def _port(dtype, seed=21):
    root.common.precision_type = dtype
    prng.seed_all(seed)
    wf = StandardWorkflow(name="torch_alexnet",
                          loader_factory=_loader(ArrayLoader),
                          layers=_slice_layers(),
                          decision_config={"max_epochs": 100})
    wf.initialize(device="cpu")
    return wf


def _ref_step(wf):
    wf.loader._fire()
    wf._region_unit._fire()
    wf.decision._fire()


_STATE_ATTRS = ("weights", "bias", "accumulated_gradient_weights",
                "accumulated_gradient_bias")


def _ref_tensors(wf):
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _STATE_ATTRS:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                out[f"{unit.name}.{attr}"] = _read(vec)
    return out


def _port_tensors(wf):
    return {f"{unit.name}.{name}": t.detach().float().numpy().copy()
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]}


def _assert_close(got, want, dtype):
    assert set(got) == set(want)
    for key, w in want.items():
        kind = "momentum" if "accumulated" in key else "weights"
        atol = SLICE_TOL[dtype][kind] * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol,
                                   err_msg=key)


def test_same_seed_gives_the_reference_initial_state():
    ref, port = _reference("bfloat16"), _port("bfloat16")
    assert [u.name for u in port.forwards] == [u.name for u in ref.forwards]
    assert [u.name for u in port.gds] == [u.name for u in ref.gds]
    want, got = _ref_tensors(ref), _port_tensors(port)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # conv weights are HWIO parameters, as the reference's
    assert tuple(port.forwards[0].weights.shape) == (5, 5, 3, 8)
    # the uint8 dataset stays uint8; the gather normalizes it
    assert port.loader.original_data.dtype == torch.uint8


_REF_RUN = """
import pickle, sys
import test_torch_alexnet as t
pickle.dump(t._reference_steps(sys.argv[1], 6), open(sys.argv[2], "wb"))
"""


def _reference_steps(dtype, n):
    """The reference's state, then ``(minibatch class, tensors, epoch
    losses)`` after each of ``n`` steps."""
    ref = _reference(dtype)
    state, steps = copy.deepcopy(ref.state_dict()), []  # not live views
    for _ in range(n):
        _ref_step(ref)
        steps.append((ref.loader.minibatch_class, _ref_tensors(ref),
                      list(ref.decision.epoch_loss),
                      list(ref.decision.last_epoch_n_err)))
    return state, steps


def _reference_steps_without_excess_precision(dtype, tmp_path):
    """:func:`_reference_steps` in a fresh process whose XLA keeps every
    rounding the program asks for.  XLA's CPU compiler by default drops
    a bf16 round trip (``xla_allow_excess_precision``), so the
    reference's bf16 conv output reaches its bias add unrounded on the
    CPU, where its ``conv_raw`` (and the TPU) round it to bf16 first, as
    the port does.  The flag is read once per process."""
    out = tmp_path / "reference_steps.pkl"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_allow_excess_precision=false"]).strip(),
        PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests),
                                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REF_RUN, dtype, str(out)],
                   check=True, env=env, timeout=300)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_the_reference(dtype, tmp_path):
    if dtype == "float32":
        state, steps = _reference_steps(dtype, 6)
    else:
        state, steps = _reference_steps_without_excess_precision(dtype,
                                                                 tmp_path)
    port = _port(dtype, seed=3)  # every weight must come from the state
    port.load_reference_state(state)
    classes = []
    for cls, want, losses, n_err in steps:
        before = _port_tensors(port)
        port.step()
        assert port.loader.minibatch_class == cls
        classes.append(cls)
        # dropout sees the loader's mode: train only on train minibatches
        assert all(u.forward_mode == ("train" if cls == TRAIN else "eval")
                   for u in port.forwards if hasattr(u, "forward_mode"))
        after = _port_tensors(port)
        if cls == VALID:
            for key in before:
                np.testing.assert_array_equal(after[key], before[key])
        _assert_close(after, want, dtype)
    assert classes == [VALID, TRAIN, TRAIN, TRAIN, VALID, TRAIN]
    assert list(port.decision.last_epoch_n_err) == n_err
    for got, want in zip(port.decision.epoch_loss, losses):
        if want is None:
            assert got is None
        else:
            assert abs(got - want) <= SLICE_TOL[dtype]["loss"] * abs(want)


def test_sample_matches_the_reference_sample():
    cfg = dict(alexnet.DEFAULTS)
    assert cfg == dict(ref_root.alexnet.as_dict())
    assert alexnet.layers(cfg) == ref_alexnet.layers(cfg)
    x, y = datasets.synthetic_imagenet(3, size=11, n_classes=5)
    rx, ry = ref_datasets.synthetic_imagenet(3, size=11, n_classes=5)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    # the streaming branch: the reference's FileImageLoader settings
    # (tests/test_torch_vision_dirs.py trains it)
    port = alexnet.build(streaming_dir="/nonexistent").loader
    ref = ref_alexnet.build(streaming_dir="/nonexistent").loader
    for attr in ("train_dir", "validation_fraction", "out_hw", "resize_hw",
                 "max_minibatch_size", "random_crop", "random_flip",
                 "normalization_scale", "normalization_bias"):
        assert getattr(port, attr) == getattr(ref, attr), attr


def test_full_width_alexnet_steps_on_the_cpu():
    """``alexnet.build()`` at full width (B = 2, bf16, dropout 0.5): the
    reference's geometry, uint8 frames normalized in the gather, and
    a train step with a finite loss that moves every parameter."""
    root.common.precision_type = "bfloat16"
    prng.seed_all(5)
    wf = alexnet.build(minibatch_size=2, n_train_samples=2,
                       n_valid_samples=0, max_epochs=1)
    wf.initialize(device="cpu")
    shapes = [u.output_shape for u in wf.forwards]
    assert shapes[:3] == [(55, 55, 96), (55, 55, 96), (27, 27, 96)]
    assert shapes[9] == (6, 6, 256) and shapes[-1] == (1000,)
    before = [p.detach().clone() for p in wf.forwards.parameters()]
    wf.step()
    raw = torch.from_numpy(datasets.synthetic_imagenet(2)[0])
    # x·scale + bias rounded once to f32, as a fused multiply-add
    want = (raw.double() * float(np.float32(2.0 / 255.0)) - 1.0).float()
    want = want.to(torch.bfloat16)
    got = wf.loader.minibatch_data
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.sort(0).values, want.sort(0).values)
    seeds = [u.seed for u in wf.forwards if hasattr(u, "seed")]
    assert len(seeds) == 2 and None not in seeds
    assert np.isfinite(wf.decision.epoch_loss[TRAIN])
    for b, p in zip(before, wf.forwards.parameters()):
        assert torch.isfinite(p).all() and not torch.equal(b, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale, bias", [(2.0 / 255.0, -1.0),
                                         (0.017, -0.45)])
def test_uint8_gather_rounds_as_the_reference(scale, bias, dtype):
    """Every uint8 value normalizes to the bits of the reference's
    compiled gather, which rounds x·scale + bias once (a fused
    multiply-add): the port looks the pixels up in a 256-entry table."""
    import jax
    import jax.numpy as jnp
    values = np.arange(256, dtype=np.uint8).reshape(256, 1, 1, 1)
    ref = jax.jit(lambda v: v.astype(jnp.float32) * jnp.float32(scale)
                  + jnp.float32(bias))(values)
    loader = ArrayLoader(train_data=values,
                         train_labels=np.zeros(256, np.int32),
                         minibatch_size=256, normalization_scale=scale,
                         normalization_bias=bias)
    loader.initialize(torch.device("cpu"), getattr(torch, dtype))
    loader.run()
    got = loader.minibatch_data
    want = torch.from_numpy(np.array(ref)).to(loader.act_store_dtype)
    assert got.dtype == loader.act_store_dtype
    assert torch.equal(got[loader._order.argsort()], want)


def test_step_marks_each_unit_in_order():
    """``step(mark)`` names each unit just after it ran: the loader, the
    forwards and the evaluator on every minibatch, then the backward
    units from the last to the first on a train minibatch, and the
    anomaly guard (on by default) last on every minibatch."""
    port = _port("float32")
    head = [port.loader.name, *(u.name for u in port.forwards),
            port.evaluator.name]
    for cls in (VALID, TRAIN):
        names = []
        port.step(names.append)
        assert port.loader.minibatch_class == cls
        assert names == head + ([u.name for u in reversed(port.gds)]
                                if cls == TRAIN else []) \
            + [port.anomaly_guard.name]
