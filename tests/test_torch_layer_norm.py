"""The port's layer-norm forward against the reference's Pallas kernel.

The reference kernel (``znicz_tpu.ops.pallas_kernels._ln_fwd_kernel``,
through ``layer_norm_forward``) runs in interpret mode on the CPU.  The
port's counterpart on the CPU is
:func:`znicz_tpu_torch.ops.fused_kernels.layer_norm_forward_plain`, the
plain version its kernel wrapper takes for CPU tensors; the CUDA kernel
is held to that plain version on the card by ``chip_smoke.py``.

Tolerances: a float32 x agrees to 2e-6 (f32 statistics in both, summed
in another order); a bf16 x stores its output in bf16 in both, so the
two may differ by one bf16 rounding step of the output (2⁻⁷ relative)
where the f32 values straddle a rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
