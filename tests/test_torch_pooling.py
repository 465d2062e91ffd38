"""The port's pooling units against the reference's, on the CPU.

Each of ``MaxAbsPooling``, ``AvgPooling`` and ``StochasticPooling``
(eval mode, and train mode's backward from an injected choice), with
its backward unit, is held against the reference's offset-recording
``numpy_run`` oracle on the same inputs: CIFAR's 32 → 16 geometry (3×3
windows at stride 2, the last window cut at the edge), a non-square
window whose stride differs from its size, an input no larger than the
window (one output) and an odd size, in f32 and bf16.  Train-mode
stochastic choices, whose random streams differ between the packages,
are held to their distribution.

Tolerances, relative to the largest |reference| of each tensor:

- f32: 1e-6 — the selections are exact; sums (window means, errors of
  overlapping windows) differ in summation order only;
- bf16: 2⁻⁸, one bf16 rounding — the port sums in f32 and rounds once
  to bf16, the oracle (fed the same bf16 values) sums in f32, and its
  result is rounded here to bf16 before the comparison.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.ops import gd_pooling as ref_gd_pooling
from znicz_tpu.ops import pooling as ref_pooling
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.ops import pooling
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}

KINDS = [("maxabs_pooling", ref_pooling.MaxAbsPooling,
          ref_gd_pooling.GDMaxAbsPooling),
         ("avg_pooling", ref_pooling.AvgPooling,
          ref_gd_pooling.GDAvgPooling)]

GEOMS = [
    # CIFAR's first pool: 32 → 16, the last window cut at the edge
    ("cifar", (2, 32, 32, 3), {"kx": 3, "ky": 3, "sliding": (2, 2)}),
    # kx ≠ sliding, a non-square window, overlapping rows
    ("kx_ne_sliding", (2, 9, 10, 3), {"kx": 3, "ky": 2, "sliding": (1, 2)}),
    # h ≤ ky: one window over the whole (cut) input
    ("h_le_ky", (3, 2, 3, 2), {"kx": 3, "ky": 3}),
    # an odd size: 7 → 3 with cut windows on both axes
    ("odd", (2, 7, 7, 4), {"kx": 3, "ky": 3, "sliding": (3, 3)}),
]


def _bf16_values(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a`` as the values the port's tensors of ``dtype`` hold."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _ref_oracle(fwd_cls, gd_cls, x, err, geom, forward_mode=None,
                choice=None):
    """The reference's numpy_run pair: ``(y, err_input, fwd)``."""
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    fwd = fwd_cls(wf, **geom)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=NumpyDevice())
    if forward_mode is not None:
        fwd.forward_mode = forward_mode
    fwd.numpy_run()
    if choice is not None:
        fwd.last_choice.map_invalidate()
        fwd.last_choice.mem[...] = choice
    dx = None
    if gd_cls is not None:
        err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
        bwd = gd_cls(wf)
        bwd.forward_unit = fwd
        bwd.link_attrs(fwd, "input", "output")
        bwd.link_attrs(err_src, ("err_output", "err"))
        bwd.initialize(device=NumpyDevice())
        bwd.numpy_run()
        bwd.err_input.map_read()
        dx = bwd.err_input.mem.copy()
    fwd.output.map_read()
    return fwd.output.mem.copy(), dx, fwd


def _assert_close(got, want, dtype, what):
    want = _bf16_values(np.asarray(want, np.float32), dtype)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, f"{what}: {err} > {TOL[dtype]}·{scale}"


def _inputs(shape, out_shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    x = _bf16_values(rng.normal(0, 1, shape).astype(np.float32), dtype)
    err = _bf16_values(rng.normal(0, 1, out_shape).astype(np.float32),
                       dtype)
    return x, err


def _port_pair(type_name, shape, dtype, geom):
    tdt = getattr(torch, dtype)
    unit = layer_type(type_name)(shape[1:], tdt, **geom)
    return unit, gd_for(type(unit))(unit, need_err_input=True), tdt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,geom", GEOMS)
@pytest.mark.parametrize("type_name,fwd_cls,gd_cls", KINDS)
def test_pooling_matches_the_reference_oracle(type_name, fwd_cls, gd_cls,
                                              name, shape, geom, dtype):
    unit, gd, tdt = _port_pair(type_name, shape, dtype, geom)
    x, err = _inputs(shape, (shape[0], *unit.output_shape), dtype)
    want_y, want_dx, _ = _ref_oracle(fwd_cls, gd_cls, x, err, geom)
    tx = torch.from_numpy(x).to(tdt)
    with torch.enable_grad():  # a train step: max-abs keeps its winners
        y = unit(tx)
    dx = gd.run(tx, torch.from_numpy(err).to(tdt), y)
    assert y.dtype == dx.dtype == tdt
    assert tuple(y.shape) == want_y.shape and tuple(dx.shape) == x.shape
    _assert_close(y.float().numpy(), want_y, dtype, "y")
    _assert_close(dx.float().numpy(), want_dx, dtype, "err_input")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxabs_signed_ties_go_to_the_first_cell(dtype):
    """|a| = |b| with opposite signs in one window: the first cell in
    row-major window order wins, its sign kept, and takes the error, as
    in the reference.  A cut window's padding never wins, whatever the
    values: every input is negative here."""
    geom = {"kx": 3, "ky": 3, "sliding": (2, 2)}
    x = -np.abs(np.random.default_rng(2).normal(0, 1, (1, 4, 4, 2))
                ).astype(np.float32) - 0.5
    x[0, 0, 1, 0], x[0, 1, 0, 0] = -3.0, 3.0   # window (0, 0): −3 first
    x[0, 2, 2, 1], x[0, 2, 3, 1] = 4.0, -4.0   # window (1, 1): +4 first
    x = _bf16_values(x, dtype)
    unit, gd, tdt = _port_pair("maxabs_pooling", x.shape, dtype, geom)
    err = _bf16_values(np.arange(1, 9, dtype=np.float32).reshape(
        1, 2, 2, 2), dtype)
    want_y, want_dx, _ = _ref_oracle(ref_pooling.MaxAbsPooling,
                                     ref_gd_pooling.GDMaxAbsPooling, x, err,
                                     geom)
    tx = torch.from_numpy(x).to(tdt)
    with torch.enable_grad():
        y = unit(tx)
    dx = gd.run(tx, torch.from_numpy(err).to(tdt), y)
    assert float(y[0, 0, 0, 0]) == -3.0 and float(y[0, 1, 1, 1]) == 4.0
    assert np.isfinite(y.float().numpy()).all()
    np.testing.assert_array_equal(y.float().numpy(), want_y)
    np.testing.assert_array_equal(dx.float().numpy(), want_dx)


@pytest.mark.parametrize("size", [32, 31, 2])
def test_avg_pooling_divides_a_cut_window_by_its_true_count(size):
    """Ones in, ones out: every window, cut or whole, is a mean; and the
    corner window of an odd input is its single cell."""
    geom = {"kx": 3, "ky": 3, "sliding": (2, 2)}
    unit = pooling.AvgPooling((size, size, 2), torch.float32, **geom)
    y = unit(torch.ones(1, size, size, 2))
    assert torch.equal(y, torch.ones_like(y))
    x = torch.randn(1, size, size, 2)
    y = unit(x)
    if size == 31:  # 15 windows, the last starting at 28: 28..30 whole
        torch.testing.assert_close(y[0, -1, -1], x[0, 28:, 28:].mean((0, 1)))
    if size == 32:  # the last window starts at 30 and holds 2 × 2 cells
        torch.testing.assert_close(y[0, -1, -1], x[0, 30:, 30:].mean((0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,geom", GEOMS)
def test_stochastic_pooling_matches_the_reference(name, shape, geom, dtype):
    """Eval mode against the oracle's probability-weighted mean; train
    mode's backward against the oracle's from the same injected choice,
    and train mode's output is the input at the port's own choice."""
    unit, gd, tdt = _port_pair("stochastic_pooling", shape, dtype, geom)
    x, err = _inputs(shape, (shape[0], *unit.output_shape), dtype, seed=6)
    want_y, _, _ = _ref_oracle(ref_pooling.StochasticPooling, None, x, err,
                               geom, forward_mode="eval")
    tx = torch.from_numpy(x).to(tdt)
    unit.forward_mode = "eval"
    y = unit(tx)
    assert unit.seed is None and y.dtype == tdt
    _assert_close(y.float().numpy(), want_y, dtype, "eval y")

    prng.seed_all(3)
    unit.forward_mode = "train"
    y = unit(tx)
    choice = unit.last_choice.numpy().copy()
    assert unit.seed is not None and choice.dtype == np.int32
    assert choice.min() >= 0 and choice.max() < unit.window
    _, want_dx, ref = _ref_oracle(ref_pooling.StochasticPooling,
                                  ref_gd_pooling.GDStochasticPooling, x, err,
                                  geom, forward_mode="train", choice=choice)
    # the port's output is the input at its choice, full-window offsets
    h, w = shape[1], shape[2]
    for oy, ox, y0, y1, x0, x1 in ref._windows(h, w):
        win = ref.full_window(x, y0, y1, x0, x1)
        picked = np.take_along_axis(win, choice[:, oy, ox, None, :],
                                    axis=1)[:, 0]
        assert np.isfinite(picked).all()  # never a cell outside the input
        np.testing.assert_array_equal(y[:, oy, ox].float().numpy(), picked)
    dx = gd.run(tx, torch.from_numpy(err).to(tdt), y)
    _assert_close(dx.float().numpy(), want_dx, dtype, "train err_input")


def test_stochastic_choices_follow_the_positive_part():
    """One 2×2 window of values (3, 1, −2, 0) on 20,000 (sample, channel)
    pairs: cells are drawn with probability 3/4, 1/4, 0, 0; a window of
    values all ≤ 0 draws each of its cells inside the input uniformly
    (a 3-wide window cut to 2 columns: two cells of 1/2).  Each frequency
    within 4σ of its probability."""
    n = 20000
    prng.seed_all(11)
    unit = pooling.StochasticPooling((2, 2, 1), torch.float32, kx=2, ky=2)
    x = torch.tensor([3.0, 1.0, -2.0, 0.0]).view(1, 2, 2, 1).expand(
        n, 2, 2, 1).contiguous()
    unit(x)
    counts = np.bincount(unit.last_choice.numpy().ravel(), minlength=4)
    for count, p in zip(counts, (0.75, 0.25, 0.0, 0.0)):
        assert abs(count / n - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-12
    cut = pooling.StochasticPooling((1, 2, 1), torch.float32, kx=3, ky=1)
    cut(-torch.ones(n, 1, 2, 1))
    counts = np.bincount(cut.last_choice.numpy().ravel(), minlength=3)
    assert counts[2] == 0
    assert abs(counts[0] / n - 0.5) <= 4 * np.sqrt(0.25 / n)


def test_stochastic_seed_comes_from_the_port_stream():
    """The train-mode draw takes one seed from the default generator, so
    the same stream state gives the same choices."""
    unit = pooling.StochasticPooling((6, 6, 3), torch.float32, kx=2, ky=2)
    x = torch.randn(4, 6, 6, 3)
    prng.seed_all(21)
    unit(x)
    first, seed = unit.last_choice.clone(), unit.seed
    prng.seed_all(21)
    unit(x)
    assert unit.seed == seed and torch.equal(unit.last_choice, first)
