"""The port's layer norm against the reference's Pallas kernels.

The reference kernels (``znicz_tpu.ops.pallas_kernels._ln_fwd_kernel``
and ``_ln_bwd_kernel``, through ``layer_norm_forward`` and
``layer_norm_backward``) run in interpret mode on the CPU.  The
port's counterparts on the CPU are
:func:`znicz_tpu_torch.ops.fused_kernels.layer_norm_forward_plain` and
``layer_norm_backward_plain``, the plain versions its kernel wrappers
take for CPU tensors; the CUDA kernels are held to them on the card by
``chip_smoke.py``.

Tolerances: a float32 x agrees to 2e-6 (f32 statistics in both, summed
in another order); a bf16 x stores its output in bf16 in both, so the
two may differ by one bf16 rounding step of the output (2⁻⁷ relative)
where the f32 values straddle a rounding boundary.  Backward: dx 1e-6
for float32 and one bf16 step of the largest |dx| for bf16, as above;
the f32 γ/β sums 1e-5 of the sum of the absolute terms (f32 terms
added in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.ops.pallas_kernels import layer_norm_backward as ref_ln_bwd
from znicz_tpu.ops.pallas_kernels import layer_norm_forward as ref_ln
from znicz_tpu_torch.ops import fused_kernels as fk

EPS = 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return (rng.normal(0.5, 2.0, shape).astype(np.float32),
            rng.normal(1.0, 0.1, d).astype(np.float32),
            rng.normal(0.0, 0.1, d).astype(np.float32))


@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("shape", [(2, 37, 64), (5, 48)])
def test_plain_matches_reference_kernel_f32(with_beta, shape):
    x, g, b = _inputs(shape, seed=len(shape))
    beta = b if with_beta else None
    want = ref_ln(jnp.asarray(x), jnp.asarray(g),
                  None if beta is None else jnp.asarray(beta), EPS,
                  interpret=True)
    got = fk.layer_norm_forward_plain(
        torch.from_numpy(x), torch.from_numpy(g),
        None if beta is None else torch.from_numpy(beta), EPS)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("with_beta", [True, False])
def test_plain_matches_reference_kernel_bf16(with_beta):
    x, g, b = _inputs((4, 16, 32), seed=7)
    beta = b if with_beta else None
    want = ref_ln(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g),
                  None if beta is None else jnp.asarray(beta), EPS,
                  interpret=True)
    assert want.dtype == jnp.bfloat16
    got = fk.layer_norm_forward_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g),
        None if beta is None else torch.from_numpy(beta), EPS)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=0)


def test_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    x, g, b = (torch.from_numpy(a) for a in _inputs((3, 40), seed=1))
    before = fk.layer_norm_forward.launches
    assert torch.equal(fk.layer_norm_forward(x, g, b, EPS),
                       fk.layer_norm_forward_plain(x, g, b, EPS))
    assert fk.layer_norm_forward.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fk.layer_norm_forward(x.to("meta"), g.to("meta"), b.to("meta"),
                              EPS)


def test_wrapper_checks_parameter_shapes():
    x, g, b = (torch.from_numpy(a) for a in _inputs((3, 40), seed=2))
    with pytest.raises(ValueError, match="gamma shape"):
        fk.layer_norm_forward(x, g[:-1], b, EPS)
    with pytest.raises(ValueError, match="beta shape"):
        fk.layer_norm_forward(x, g, b[:-1], EPS)


def test_layer_norm_unit_matches_reference_unit_math():
    """The port's ``LayerNorm`` unit: γ/β from the bundle's
    ``weights``/``bias``, output stored at the activation dtype."""
    from znicz_tpu_torch.ops.layer_norm import LayerNorm
    x, g, b = _inputs((2, 8, 32), seed=4)
    unit = LayerNorm((8, 32), torch.bfloat16, eps=EPS)
    unit.load_params({"weights": torch.from_numpy(g),
                      "bias": torch.from_numpy(b)})
    assert unit.weights.dtype == torch.float32
    y = unit(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = ref_ln(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g),
                  jnp.asarray(b), EPS, interpret=True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=0)
    with pytest.raises(ValueError, match="missing"):
        LayerNorm((8, 32), torch.float32).load_params(
            {"weights": torch.from_numpy(g)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_beta", [True, False])
# 700 rows: two of the reference's 512-row tiles, the second ragged
@pytest.mark.parametrize("shape", [(7, 100, 48), (3, 5, 40)])
def test_backward_plain_matches_reference_kernel(dtype, with_beta, shape):
    x, g, _ = _inputs(shape, seed=shape[0])
    err = np.random.default_rng(9).normal(0, 0.1, shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want_dx, want_g, want_b = ref_ln_bwd(
        jnp.asarray(x).astype(jdt), jnp.asarray(err).astype(jdt),
        jnp.asarray(g), EPS, with_beta=with_beta, interpret=True)
    tx, terr = (torch.from_numpy(a).to(tdt) for a in (x, err))
    dx, grad_g, grad_b = fk.layer_norm_backward_plain(
        tx, terr, torch.from_numpy(g), EPS, with_beta)
    assert dx.dtype == tdt and dx.shape == x.shape
    assert grad_g.dtype == torch.float32 and grad_g.shape == (shape[-1],)
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    dx_tol = 1e-6 if dtype == "float32" else \
        2.0 ** -7 * np.abs(want_dx).max()
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=dx_tol)
    xf, ef = tx.float().reshape(-1, shape[-1]), terr.float().reshape(
        -1, shape[-1])
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, unbiased=False, keepdim=True) + EPS)
    for got, want, terms in ((grad_g, want_g, ef * xhat),
                             (grad_b, want_b, ef)):
        if not with_beta and want is None:
            assert got is None
            continue
        bound = 1e-5 * terms.abs().sum(0).numpy()
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


def test_backward_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    x, g, _ = (torch.from_numpy(a) for a in _inputs((3, 40), seed=6))
    err = torch.ones_like(x)
    before = fk.layer_norm_backward.launches
    for got, want in zip(fk.layer_norm_backward(x, err, g, EPS),
                         fk.layer_norm_backward_plain(x, err, g, EPS)):
        assert torch.equal(got, want)
    assert fk.layer_norm_backward.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fk.layer_norm_backward(x.to("meta"), err.to("meta"), g.to("meta"),
                               EPS)
    with pytest.raises(ValueError, match="does not match"):
        fk.layer_norm_backward(x, err[:, :-1], g, EPS)


def test_gd_layer_norm_updates_gamma_beta_and_returns_dx():
    """``GDLayerNorm``: dx in the activation dtype, γ/β moved by the
    base rule from the kernel's sums (plain SGD here: W −= lr·g)."""
    from znicz_tpu_torch.ops.layer_norm import GDLayerNorm, LayerNorm
    x, g, b = _inputs((2, 8, 32), seed=5)
    unit = LayerNorm((8, 32), torch.bfloat16, eps=EPS)
    unit.load_params({"weights": torch.from_numpy(g),
                      "bias": torch.from_numpy(b)})
    gd = GDLayerNorm(unit, learning_rate=0.5)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    err = torch.full_like(tx, 0.01)
    want_dx, want_g, want_b = fk.layer_norm_backward_plain(
        tx, err, unit.weights.detach().clone(), EPS)
    dx = gd.run(tx, err)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, want_dx)
    np.testing.assert_array_equal(unit.weights.detach().numpy(),
                                  (torch.from_numpy(g) - 0.5 * want_g)
                                  .numpy())
    np.testing.assert_array_equal(unit.bias.detach().numpy(),
                                  (torch.from_numpy(b) - 0.5 * want_b)
                                  .numpy())
