"""The port's LRN against the reference: the plain versions of the B1/B2
kernels against the reference's Pallas kernels (``lrn_forward`` and
``lrn_backward`` in interpret mode), and the port's LRN units against
the reference's units.

Tolerances (relative to the largest |reference|):

- float32 plain vs Pallas: 2e-6 — the window sums add in the same
  channel order; the port takes d^(−0.75) as rsqrt(d·√d) where the
  Pallas kernel calls pow, a few f32 ulps apart;
- bf16 storage: one bf16 step (2⁻⁷ of the largest value), since both
  round an f32 result once and the f32 results differ in the last bits;
- the units in bf16 mode: 2⁻⁷ as well, though the reference's XLA path
  rounds d to bf16 (d = k + α·Σx² ≈ 2, so its rounding moves y by at
  most β·2⁻⁸ relative) and the port, following the Pallas kernels,
  does not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.ops import normalization as ref_norm
from znicz_tpu.ops import pallas_kernels
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.ops import fused_kernels as fk
from znicz_tpu_torch.ops.normalization import (LRNormalizerBackward,
                                               LRNormalizerForward)

ALEXNET = dict(alpha=1e-4, beta=0.75, k=2.0)
F32_TOL = 2e-6
BF16_TOL = 2.0 ** -7


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _x(rows, c, seed, scale=30.0):
    # AlexNet's conv outputs are large enough that α·Σx² moves d off k
    return (np.random.default_rng(seed).normal(0, scale, (rows, c))
            .astype(np.float32))


@pytest.mark.parametrize("n", [5, 4, 3])
@pytest.mark.parametrize("rows,c,beta", [
    (1100, 7, 0.75),     # three Pallas row tiles, an odd channel count
    (40, 96, 0.6),       # AlexNet's conv1 width, a beta taken by pow
])
def test_plain_matches_pallas_kernels(n, rows, c, beta):
    cfg = dict(ALEXNET, beta=beta, n=n)
    x = _x(rows, c, seed=n + c)
    err = np.random.default_rng(n).normal(0, 1, x.shape).astype(np.float32)
    want_y = np.asarray(pallas_kernels.lrn_forward(
        jnp.asarray(x), interpret=True, **cfg))
    want_dx = np.asarray(pallas_kernels.lrn_backward(
        jnp.asarray(x), jnp.asarray(err), interpret=True, **cfg))
    tx, terr = torch.from_numpy(x), torch.from_numpy(err)
    y = fk.lrn_forward_plain(tx, **cfg)
    dx = fk.lrn_backward_plain(tx, terr, **cfg)
    assert y.dtype == dx.dtype == torch.float32
    assert _rel(y, want_y) <= F32_TOL
    assert _rel(dx, want_dx) <= F32_TOL
    # bf16 storage: f32 math on the bf16 values, rounded once
    xb, eb = tx.to(torch.bfloat16), terr.to(torch.bfloat16)
    want_yb = np.asarray(pallas_kernels.lrn_forward(
        jnp.asarray(xb.float().numpy()), interpret=True, **cfg))
    want_dxb = np.asarray(pallas_kernels.lrn_backward(
        jnp.asarray(xb.float().numpy()), jnp.asarray(eb.float().numpy()),
        interpret=True, **cfg))
    yb = fk.lrn_forward_plain(xb, **cfg)
    dxb = fk.lrn_backward_plain(xb, eb, **cfg)
    assert yb.dtype == dxb.dtype == torch.bfloat16
    assert _rel(yb.float(), want_yb) <= BF16_TOL
    assert _rel(dxb.float(), want_dxb) <= BF16_TOL


def test_backward_is_the_gradient_of_the_forward_for_even_n():
    """n = 4: the backward's window is the forward window's adjoint,
    which autograd of the forward gives independently (both in f32, so
    to a few f32 ulps)."""
    cfg = dict(ALEXNET, n=4)
    x = torch.from_numpy(_x(6, 9, seed=2)).double().requires_grad_()
    err = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (6, 9)))
    fk.lrn_forward_plain(x, **cfg).backward(err)
    dx = fk.lrn_backward_plain(x.detach(), err, **cfg)
    assert _rel(dx.double().numpy(), x.grad.numpy()) <= F32_TOL
    # the forward window itself would not do: n = 4 is asymmetric
    half = 4 // 2
    assert half != 4 - 1 - half


def _ref_lrn(x, err, dtype, n):
    ref_root.common.precision_type = dtype
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    fwd = ref_norm.LRNormalizerForward(wf, n=n, **ALEXNET)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=XLADevice())
    err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = ref_norm.LRNormalizerBackward(wf)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output")
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=XLADevice())
    fwd.run()
    bwd.run()
    fwd.output.map_read()
    bwd.err_input.map_read()
    return (np.asarray(fwd.output.mem).astype(np.float32),
            np.asarray(bwd.err_input.mem).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5, 4])
def test_units_match_the_reference_units(dtype, n):
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(n)
    # values the bf16 activations can hold, so both start from the same
    x = torch.from_numpy(rng.normal(0, 30, (2, 5, 4, 12)).astype(
        np.float32)).to(tdt)
    err = torch.from_numpy(rng.normal(0, 1, x.shape).astype(
        np.float32)).to(tdt)
    want_y, want_dx = _ref_lrn(x.float().numpy(), err.float().numpy(),
                               dtype, n)
    unit = LRNormalizerForward(tuple(x.shape[1:]), tdt, n=n, **ALEXNET)
    gd = LRNormalizerBackward(unit, need_err_input=True)
    y = unit(x)
    dx = gd.run(x, err, y)
    assert y.dtype == dx.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(y.float(), want_y) <= tol
    assert _rel(dx.float(), want_dx) <= tol


def test_wrappers_take_the_plain_versions_for_cpu_tensors_only():
    x = torch.from_numpy(_x(8, 6, seed=1)).to(torch.bfloat16)
    err = torch.ones_like(x)
    before = (fk.lrn_forward.launches, fk.lrn_backward.launches)
    assert torch.equal(fk.lrn_forward(x, n=5, **ALEXNET),
                       fk.lrn_forward_plain(x, n=5, **ALEXNET))
    assert torch.equal(fk.lrn_backward(x, err, n=5, **ALEXNET),
                       fk.lrn_backward_plain(x, err, n=5, **ALEXNET))
    assert (fk.lrn_forward.launches, fk.lrn_backward.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        fk.lrn_forward(x.to("meta"), n=5, **ALEXNET)
    with pytest.raises(ValueError, match="does not match"):
        fk.lrn_backward(x, err[:4], n=5, **ALEXNET)
