"""The last op units of the port against the reference, on the CPU
(the port of ``tests/test_cutter_joiner.py``, ``tests/test_zerofilling.py``,
``tests/test_diversity.py`` and the image saver).

- ``Cutter``/``GDCutter``, ``InputJoiner``/``GDInputJoiner`` and
  ``MeanDispNormalizer``/``GDMeanDispNormalizer``, forward and backward,
  against the reference's ``xla_run`` and ``numpy_run``, exact (f32: a
  slice, a pad, a concatenation, a subtraction and a product); a
  ``cutter`` layer in a ``StandardWorkflow`` (conv → cutter →
  max_pooling → all2all → softmax) stepped beside the reference's
  through a validation step into train steps, every parameter and
  momentum within 1e-5 of its largest |value| (and bit-equal on the
  numpy oracle).
- ``ZeroFiller`` after the backward chain of that chain (in the port's
  region), 3 train steps: the masked entries exactly 0, the rest equal
  to the reference's (within 1e-5 as above; bit-equal on the oracle).
- ``FixAccumulator`` and ``RangeAccumulator`` fed the same arrays: their
  histograms equal to the reference's, the range accumulator's
  approximate rebin past ``max_retained`` included.
- ``diversity``: the similarity within 1e-6 of the reference's (numpy,
  and the torch path against the reference's ``xp=jnp`` path), the
  groups and the score equal, HWIO conv weights; the reporter's report.
- ``ImageSaver`` through ``link_image_saver`` on a small softmax
  workflow (L and RGB samples) on both oracles: the same file names and
  the same pixels, the port's PNGs decoded with PIL; ``run_chunked(4)``
  with the saver linked writes the files ``run()`` writes.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from znicz_tpu.backends import NumpyDevice as RefNumpyDevice
from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.memory import Vector as RefVector
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.ops import accumulator as ref_acc
from znicz_tpu.ops import cutter as ref_cutter
from znicz_tpu.ops import diversity as ref_div
from znicz_tpu.ops import input_joiner as ref_joiner
from znicz_tpu.ops import mean_disp_normalizer as ref_mdn
from znicz_tpu.ops.weights_zerofilling import ZeroFiller as RefZeroFiller
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.ops import accumulator, diversity
from znicz_tpu_torch.ops.cutter import Cutter, GDCutter
from znicz_tpu_torch.ops.image_saver import write_png
from znicz_tpu_torch.ops.input_joiner import GDInputJoiner, InputJoiner
from znicz_tpu_torch.ops.mean_disp_normalizer import (GDMeanDispNormalizer,
                                                      MeanDispNormalizer)
from znicz_tpu_torch.ops.weights_zerofilling import ZeroFiller
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

RNG = np.random.default_rng(5)
X = RNG.normal(size=(2, 7, 9, 3)).astype(np.float32)
SEED = 17
#: a workflow step against the reference's in f32: of each tensor's
#: largest |value| (the products sum in other orders)
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    reset_root()
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    ref_root.common.engine.anomaly_guard = False
    yield
    reset_root()


def _ref_device(device):
    return RefNumpyDevice() if device == "numpy" else XLADevice()


def _value(a, device):
    return a.copy() if device == "numpy" else torch.from_numpy(a.copy())


def _np(value):
    return np.array(value if isinstance(value, np.ndarray)
                    else value.detach().numpy())


def _ref_mem(vec):
    vec.map_read()
    return np.array(vec.mem)


def _ref_pair(device, fwd_cls, bwd_cls, x, err, **attrs):
    """A reference forward and its backward around DummyUnits: the
    forward's output and the backward's err_input."""
    wf = DummyWorkflow()
    unit = fwd_cls(wf, **attrs.pop("kwargs", {}))
    unit.link_attrs(DummyUnit(wf, output=RefVector(x.copy(), name="x")),
                    ("input", "output"))
    for name, value in attrs.items():
        setattr(unit, name, RefVector(value.copy(), name=name))
    unit.initialize(device=_ref_device(device))
    unit.run()
    bwd = bwd_cls(wf)
    bwd.forward_unit = unit
    bwd.link_attrs(unit, "input", "output")
    bwd.link_attrs(DummyUnit(wf, err=RefVector(err.copy(), name="err")),
                   ("err_output", "err"))
    bwd.initialize(device=_ref_device(device))
    bwd.run()
    return _ref_mem(unit.output), _ref_mem(bwd.err_input)


def _port_pair(device, unit, bwd_cls, x, err):
    unit.initialize(device=device)
    unit.input = _value(x, device)
    unit.run()
    bwd = bwd_cls(unit)
    bwd.initialize(device=device)
    bwd.input, bwd.output = unit.input, unit.output
    bwd.err_output = _value(err, device)
    bwd.run()
    return _np(unit.output), _np(bwd.err_input)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_cutter_both_ways(device):
    padding = (2, 1, 3, 2)  # left, top, right, bottom
    err = RNG.normal(size=(2, 4, 4, 3)).astype(np.float32)
    want = _ref_pair(device, ref_cutter.Cutter, ref_cutter.GDCutter, X, err,
                     kwargs={"padding": padding})
    unit = Cutter(input_shape=X.shape[1:], padding=padding)
    assert unit.output_shape == (4, 4, 3)
    got = _port_pair(device, unit, GDCutter, X, err)
    np.testing.assert_array_equal(got[0], X[:, 1:5, 2:6, :])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == X.shape
    with pytest.raises(ValueError, match="leaves nothing"):
        Cutter(input_shape=(4, 4, 1), padding=2).initialize(device="cpu")


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_mean_disp_normalizer_both_ways(device):
    mean = X.mean(axis=0)
    rdisp = (1.0 / (X.std(axis=0) + 0.1)).astype(np.float32)
    err = RNG.normal(size=X.shape).astype(np.float32)
    want = _ref_pair(device, ref_mdn.MeanDispNormalizer,
                     ref_mdn.GDMeanDispNormalizer, X, err, mean=mean,
                     rdisp=rdisp)
    unit = MeanDispNormalizer(input_shape=X.shape[1:], mean=mean,
                              rdisp=rdisp)
    got = _port_pair(device, unit, GDMeanDispNormalizer, X, err)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(AttributeError, match="rdisp not set"):
        MeanDispNormalizer(input_shape=(3,), mean=np.zeros(3)).initialize(
            device="cpu")


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_input_joiner_both_ways(device):
    a = RNG.normal(size=(4, 5)).astype(np.float32)
    b = RNG.normal(size=(4, 2, 3)).astype(np.float32)  # flattened to 6
    err = RNG.normal(size=(4, 11)).astype(np.float32)
    wf = DummyWorkflow()
    join = ref_joiner.InputJoiner(wf)
    join.link_inputs(DummyUnit(wf, output=RefVector(a.copy(), name="a")),
                     DummyUnit(wf, output=RefVector(b.copy(), name="b")))
    join.initialize(device=_ref_device(device))
    join.run()
    bwd = ref_joiner.GDInputJoiner(wf)
    bwd.forward_unit = join
    bwd.link_attrs(DummyUnit(wf, err=RefVector(err.copy(), name="err")),
                   ("err_output", "err"))
    bwd.initialize(device=_ref_device(device))
    bwd.run()
    sources = [SimpleNamespace(output=_value(v, device), is_initialized=True,
                               sample_shape=v.shape[1:]) for v in (a, b)]
    port = InputJoiner().link_inputs(*sources)
    port.initialize(device=device)
    assert port.offsets == [0, 5, 11] and port.output_shape == (11,)
    port.run()
    np.testing.assert_array_equal(_np(port.output), _ref_mem(join.output))
    if device == "cpu":  # standalone, called with the tensors
        alone = InputJoiner(input_shapes=[(5,), (2, 3)])
        np.testing.assert_array_equal(
            _np(alone(*(s.output for s in sources))), _np(port.output))
    gd = GDInputJoiner(port)
    gd.initialize(device=device)
    gd.err_output = _value(err, device)
    gd.run()
    assert len(gd.err_inputs) == 2
    for got, vec in zip(gd.err_inputs, bwd.err_inputs):
        np.testing.assert_array_equal(_np(got), _ref_mem(vec))
    np.testing.assert_array_equal(_np(gd.err_inputs[1]),
                                  err[:, 5:].reshape(b.shape))


# -- a cutter layer and a zero filler in a StandardWorkflow --------------------------
GD = {"learning_rate": 0.05, "gradient_moment": 0.9}
CUTTER_LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                 "padding": 1}, "<-": GD},
    {"type": "cutter", "->": {"padding": (1, 2, 1, 0)}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8}, "<-": GD},
    {"type": "softmax", "->": {"output_sample_shape": 3}, "<-": GD},
]
#: the conv's weights a zero filler masks
MASK = (np.arange(3 * 3 * 3 * 4).reshape(3, 3, 3, 4) % 3 == 0)


def _images(n=30, size=9, channels=3, seed=SEED):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, size, size, channels)).astype(np.float32)
    return x, rng.integers(0, 3, size=n).astype(np.int32)


def _workflows(device, layers=CUTTER_LAYERS, x=None, y=None, **kwargs):
    if x is None:
        x, y = _images()

    def factory(cls):
        return lambda w: cls(w, train_data=x[10:], train_labels=y[10:],
                             valid_data=x[:10], valid_labels=y[:10],
                             minibatch_size=8)

    ref_prng.seed_all(SEED)
    ref = RefWorkflow(name="misc", loader_factory=factory(RefLoader),
                      layers=layers, decision_config={"max_epochs": 100},
                      **kwargs)
    prng.seed_all(SEED)
    port = StandardWorkflow(name="misc", loader_factory=factory(ArrayLoader),
                            layers=layers, decision_config={"max_epochs": 100},
                            **kwargs)
    return ref, port


def _zero_fillers(ref, port, device):
    """A zero filler on the conv's weights after each package's backward
    chain: in the port's region on the CPU device, fired after the last
    backward unit on the oracles; the reference's region runs no side
    unit, so there its filler follows the decision."""
    zr = RefZeroFiller(ref)
    zr.link_attrs(ref.forwards[0], ("target_weights", "weights"))
    zr.link_from(ref.gds[0] if device == "numpy" else ref.decision)
    zp = ZeroFiller(port)
    zp.link_attrs(port.forwards[0], ("target_weights", "weights"))
    zp.link_from(port.gds[0])
    return zr, zp


def _ref_step(wf, device):
    if device == "numpy":  # no region: its units one by one
        side = [u for u in wf.gds[0].links_to if u is not wf.decision]
        for unit in [wf.loader, *wf.forwards, wf.evaluator,
                     *reversed(wf.gds), *side]:
            if not unit.gate_skip:
                unit._fire()
    else:
        wf.loader._fire()
        wf._region_unit._fire()
    wf.decision._fire()
    for unit in wf.decision.links_to:
        if unit not in (wf.repeater, wf.end_point) and not unit.gate_skip:
            unit._fire()


def _params(ref, port):
    for unit, p_unit in zip([*ref.forwards, *ref.gds],
                            [*port.forwards, *port.gds]):
        for name, t in [*p_unit.named_parameters(recurse=False),
                        *p_unit.named_buffers(recurse=False)]:
            if name == "lr_state":
                continue
            yield f"{p_unit.name}.{name}", _np(t), _ref_mem(
                unit.__dict__[name])


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("zero_fill", [False, True])
def test_cutter_chain_steps_beside_the_reference(device, zero_fill):
    ref, port = _workflows(device)
    fillers = _zero_fillers(ref, port, device) if zero_fill else None
    ref.initialize(device=_ref_device(device))
    port.initialize(device=device)
    if fillers and device == "cpu":  # the region's last member
        assert port.region.units[-1] is fillers[1]
    assert [type(u).__name__ for u in port.forwards][1] == "Cutter"
    assert tuple(port.forwards[1].output_shape) == (7, 7, 4)
    if fillers:
        for filler, dev in zip(fillers, (ref.device, port.device)):
            filler.zero_mask.reset((~MASK).astype(np.float32))
            filler.zero_mask.initialize(dev)
    _ref_mem(ref.forwards[0].weights)
    np.testing.assert_array_equal(
        _np(port.forwards[0].weights), _ref_mem(ref.forwards[0].weights))
    classes = []
    for _ in range(5):   # two validation steps, three train steps
        _ref_step(ref, device)
        port.step()
        classes.append(port.loader.minibatch_class)
        for key, got, want in _params(ref, port):
            if device == "numpy":
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got - want).max()) <= TOL * scale, key
    assert classes == [1, 1, 2, 2, 2]
    w = _np(port.forwards[0].weights)
    if fillers:
        assert np.all(w[MASK] == 0.0) and np.all(w[~MASK] != 0.0)
    else:
        assert not np.any(w[MASK] == 0.0)


def test_a_zero_filler_trips_the_sdc_self_check_in_both_packages():
    """C17: the filler multiplies the conv's weights after the step's
    committed fingerprint (slot 0) was folded, so the next train step's
    fold of the stored value (slot 2) differs from it and the sticky
    self-check (slot 3) counts one each train step after the first, in
    the reference as in the port: a false SDC alarm on a clean run
    (the card's phase 13 reads it too).  Both packages with the guard
    and the fingerprints on, the same counts."""
    ref_root.common.engine.anomaly_guard = True
    ref, port = _workflows("cpu")
    fillers = _zero_fillers(ref, port, "cpu")
    ref.initialize(device=_ref_device("cpu"))
    port.initialize(device="cpu")
    for filler, dev in zip(fillers, (ref.device, port.device)):
        filler.zero_mask.reset((~MASK).astype(np.float32))
        filler.zero_mask.initialize(dev)
    for _ in range(5):   # two validation steps, three train steps
        _ref_step(ref, "cpu")
        port.step()
    got = port.anomaly_guard.read_sdc_fingerprint()
    want = ref.anomaly_guard.read_sdc_fingerprint()
    assert got[3] == want[3] == 2.0
    assert port.anomaly_guard.read_state() == \
        ref.anomaly_guard.read_state() == (0, 0, 0)


# -- accumulators ----------------------------------------------------------------
def test_accumulators_against_the_reference():
    rng = np.random.default_rng(3)
    batches = [rng.normal(scale=s, size=(50,)).astype(np.float32)
               for s in (0.2, 0.5, 1.0, 3.0, 0.1, 6.0)]
    wf = DummyWorkflow()
    pairs = [(ref_acc.FixAccumulator(wf, lo=-1.0, hi=1.0, n_bins=12),
              accumulator.FixAccumulator(lo=-1.0, hi=1.0, n_bins=12)),
             (ref_acc.RangeAccumulator(wf, n_bins=16),
              accumulator.RangeAccumulator(n_bins=16)),
             (ref_acc.RangeAccumulator(wf, n_bins=16, max_retained=120),
              accumulator.RangeAccumulator(n_bins=16, max_retained=120))]
    for i, values in enumerate(batches):
        for ref, port in pairs:
            ref.input = RefVector(values.copy(), name="x")
            # a tensor, a Vector and an array as the port's input
            port.input = (torch.from_numpy(values.copy()) if i % 3 == 0
                          else Vector(values.copy()) if i % 3 == 1
                          else values.copy())
            ref.run()
            port.run()
            np.testing.assert_array_equal(port.histogram.mem,
                                          ref.histogram.mem)
            assert port.n_observed == ref.n_observed
    approx = pairs[2][1]
    assert approx._samples is None  # past max_retained: approximate rebins
    assert (approx.x_min, approx.x_max) == (pairs[2][0].x_min,
                                           pairs[2][0].x_max)
    np.testing.assert_array_equal(pairs[1][1].bin_centers,
                                  pairs[1][0].bin_centers)


# -- diversity -------------------------------------------------------------------
def _weights_with_duplicates(seed=0):
    """FC weights (fan_in 20, 6 filters): 0≈3 (a copy and noise), 1≈4 (a
    negated copy), 2 and 5 independent."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(3, 20))
    cols = [base[0], base[1], base[2],
            base[0] + 0.01 * rng.normal(size=20),
            -base[1] + 0.01 * rng.normal(size=20),
            rng.normal(size=20)]
    return np.stack(cols, axis=1).astype(np.float32)


def test_diversity_against_the_reference():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(3, 3, 4)).astype(np.float32)
    conv = np.stack([base, base.copy(), rng.normal(size=(3, 3, 4))],
                    axis=-1).astype(np.float32)       # HWIO, 3 kernels
    for w in (_weights_with_duplicates(), conv):
        want = ref_div.filter_similarity(w)
        np.testing.assert_allclose(diversity.filter_similarity(w), want,
                                   atol=1e-6)
        rows = ref_div._as_filter_rows(w)
        on_xla = np.asarray(ref_div.filter_similarity(jnp.asarray(rows),
                                                      xp=jnp))
        on_torch = diversity.filter_similarity(
            diversity.filter_rows(torch.from_numpy(w)), xp=torch).numpy()
        np.testing.assert_allclose(on_torch, on_xla, atol=1e-6)
        for threshold in (0.85, 0.9):
            groups = diversity.similar_kernel_groups(w, threshold)
            assert groups == ref_div.similar_kernel_groups(w, threshold)
            assert diversity.diversity_score(w, threshold) == \
                ref_div.diversity_score(w, threshold)
    assert diversity.similar_kernel_groups(conv) == [[0, 1]]
    rep = diversity.FilterDiversityReporter(threshold=0.9)
    rep.weights_list = [torch.from_numpy(_weights_with_duplicates())]
    rep.run()
    assert rep.last_report == {"weights0": (pytest.approx(1 - 4 / 6), 2)}


# -- the image saver --------------------------------------------------------------
def _saver_workflows(device, channels, tmp_path):
    x, y = _images(n=40, size=6, channels=channels, seed=SEED + channels)
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 5},
               "<-": GD},
              {"type": "softmax", "->": {"output_sample_shape": 3},
               "<-": GD}]
    ref, port = _workflows(device, layers, x, y)
    ref.decision.max_epochs = port.decision.max_epochs = 2
    ref.link_image_saver(out_dir=str(tmp_path / "ref"), limit=5,
                         classes=(1, 2))
    port.link_image_saver(out_dir=str(tmp_path / "port"), limit=5,
                          classes=(1, 2))
    ref.initialize(device=_ref_device(device))
    port.initialize(device=device)
    return ref, port


def _files(root_dir):
    out = {}
    for dirpath, _, names in os.walk(root_dir):
        for name in names:
            path = os.path.join(dirpath, name)
            with Image.open(path) as img:
                out[os.path.relpath(path, root_dir)] = (img.mode,
                                                        np.array(img))
    return out


@pytest.mark.parametrize("channels", [1, 3])
def test_image_saver_writes_the_references_files(channels, tmp_path):
    ref, port = _saver_workflows("numpy", channels, tmp_path)
    ref.run()
    port.run()
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want) and got
    assert {mode for mode, _ in got.values()} == \
        {"L" if channels == 1 else "RGB"}
    for name, (mode, pixels) in got.items():
        assert mode == want[name][0]
        np.testing.assert_array_equal(pixels, want[name][1], err_msg=name)


def test_run_chunked_with_an_image_saver_steps_as_run(tmp_path):
    files = []
    for mode in ("run", "chunked"):
        _, port = _saver_workflows("cpu", 3, tmp_path / mode)
        if mode == "run":
            port.run()
        else:
            port.run_chunked(4)
        assert port.decision.complete
        files.append(_files(tmp_path / mode / "port"))
    assert files[0] and sorted(files[0]) == sorted(files[1])
    for name, (_, pixels) in files[0].items():
        np.testing.assert_array_equal(files[1][name][1], pixels)


def test_write_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((5, 7), (4, 3, 3), (1, 1)):
        img = rng.integers(0, 256, size=shape).astype(np.uint8)
        path = str(tmp_path / f"{len(shape)}_{shape[0]}.png")
        write_png(path, img)
        with Image.open(path) as decoded:
            assert decoded.mode == ("L" if len(shape) == 2 else "RGB")
            np.testing.assert_array_equal(np.array(decoded), img)
    with pytest.raises(ValueError, match="H×W"):
        write_png(str(tmp_path / "bad.png"), np.zeros((2, 2, 2), np.uint8))
