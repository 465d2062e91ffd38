"""The plain version of the B4 kernel against the reference's Pallas
kernel (``softmax_argmax`` in interpret mode), and ``All2AllSoftmax``'s
classification through it.

Tolerance: probabilities within 1e-6 absolute (f32 exp and another
summation order of the row sum); the argmax exactly, the first index on
ties, as ``jnp.argmax``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import pallas_kernels
from znicz_tpu_torch.ops import fused_kernels as fk
from znicz_tpu_torch.ops.all2all import All2AllSoftmax

PROB_TOL = 1e-6


def _logits(rows, c, seed):
    v = np.random.default_rng(seed).normal(0, 3, (rows, c)).astype(
        np.float32)
    # planted ties at the row maximum, and a −inf column
    v[0, 5] = v[0, 2] = v[0].max() + 1.0
    v[1, :] = 0.5
    v[2, 3] = -np.inf
    v[3, -1] = v[3, 0] = v[3].max() + 2.0
    return v


@pytest.mark.parametrize("rows,c", [(16, 8), (600, 1000)])
def test_plain_matches_pallas_kernel(rows, c):
    v = _logits(rows, c, seed=c)
    want_p, want_i = pallas_kernels.softmax_argmax(jnp.asarray(v),
                                                   interpret=True)
    p, i = fk.softmax_argmax_plain(torch.from_numpy(v))
    assert p.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), rtol=0,
                               atol=PROB_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    assert list(i[:4]) == [2, 0, int(np.argmax(v[2])), 0]
    assert float(p[2, 3]) == 0.0


def test_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    v = torch.from_numpy(_logits(8, 10, seed=1))
    before = fk.softmax_argmax.launches
    for got, want in zip(fk.softmax_argmax(v), fk.softmax_argmax_plain(v)):
        assert torch.equal(got, want)
    assert fk.softmax_argmax.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fk.softmax_argmax(v.to("meta"))
    with pytest.raises(ValueError, match="rows, classes"):
        fk.softmax_argmax(v[0])


def test_softmax_unit_classifies_through_it():
    rng = np.random.default_rng(2)
    unit = All2AllSoftmax((12,), torch.bfloat16, output_sample_shape=7)
    unit.load_params({"weights": torch.from_numpy(
        rng.normal(0, 0.5, (12, 7)).astype(np.float32)),
        "bias": torch.zeros(7)})
    x = torch.from_numpy(rng.normal(0, 1, (5, 12)).astype(np.float32))
    probs, max_idx = unit.classify(x.to(torch.bfloat16))
    logits = unit.mxu_dot(x, unit.weights) + unit.bias
    want_p, want_i = fk.softmax_argmax_plain(logits)
    assert torch.equal(probs, want_p) and torch.equal(max_idx, want_i)
    assert torch.equal(unit(x.to(torch.bfloat16)), probs)
