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


def test_route_rule():
    """Which kernel a call takes on the card (:func:`fk.softmax_route`):
    the register kernel up to 1024 classes (the AlexNet head's 1000,
    the serving buckets' and sequence stack's 8, the attention sample's
    3), the general kernel past it."""
    for c in (1, 3, 8, 33, 256, 257, 1000, fk.SOFTMAX_REGISTER_MAX_CLASSES):
        assert fk.softmax_route(c) == "register"
    for c in (fk.SOFTMAX_REGISTER_MAX_CLASSES + 1, 4096):
        assert fk.softmax_route(c) == "general"


#: csrc/softmax_argmax.cu: a block's threads, and a warp's
THREADS, WARP = 256, 32


def _better(v, i, bv, bi):
    """``better`` of csrc/softmax_argmax.cu, elementwise: (v, i) beats
    (bv, bi) when larger, or equal and earlier; a NaN beats numbers, the
    earlier of two NaNs wins."""
    vn, bn = torch.isnan(v), torch.isnan(bv)
    return torch.where(vn | bn, vn & (~bn | (i < bi)),
                       (v > bv) | ((v == bv) & (i < bi)))


def _take(keep, a, b):
    return torch.where(keep, a, b)


def _register_geometry(c, vec):
    """``(G, VW, NV)`` of the register kernel for rows of c classes: G
    threads a row, NV vectors of VW elements a thread (``reg_route``)."""
    if c <= 256:
        return 1 << (c - 1).bit_length(), 1, 1
    if vec:
        return 256, 4, 1
    return 256, 1, 2 if c <= 512 else 4


def _register_order(v, vec):
    """The register kernel's order of work in torch (f32): thread t of a
    row's group owns columns (t + k·G)·VW + j, padding (−inf, C) past
    the row; its best by a pairwise tree over its elements, then the
    shuffle tree over the group's lanes in a warp (xor distances below
    the group's width), then the group's warps in warp order; the
    exponentials kept, summed the same way, each times the reciprocal
    of the sum.  Returns (probabilities, argmax)."""
    rows, c = v.shape
    g, vw, nv = _register_geometry(c, vec)
    lanes = min(g, WARP)
    cols = ((torch.arange(g)[:, None, None]
             + g * torch.arange(nv)[None, :, None]) * vw
            + torch.arange(vw)).reshape(g, nv * vw)
    inside = cols < c
    val = torch.where(inside, v[:, cols.clamp(max=c - 1)],
                      torch.tensor(float("-inf")))
    at = torch.where(inside, cols, c).expand(rows, -1, -1)
    e_n = nv * vw

    def tree(a, b, combine):  # pairwise over a thread's elements
        a, b = list(a.unbind(-1)), list(b.unbind(-1))
        w = 1
        while w < e_n:
            for e in range(0, e_n - w, 2 * w):
                a[e], b[e] = combine(a[e], b[e], a[e + w], b[e + w])
            w *= 2
        return a[0], b[0]

    def pick(av, ai, ov, oi):
        keep = _better(ov, oi, av, ai)
        return _take(keep, ov, av), _take(keep, oi, ai)

    best, best_i = tree(val, at, pick)
    lane = torch.arange(g)
    off = lanes // 2
    while off:
        best, best_i = pick(best, best_i, best[:, lane ^ off],
                            best_i[:, lane ^ off])
        off //= 2
    warp_best = (best[:, ::lanes], best_i[:, ::lanes])  # lane 0 of each warp
    best, best_i = warp_best[0][:, 0], warp_best[1][:, 0]
    for w in range(1, g // lanes):
        best, best_i = pick(best, best_i, warp_best[0][:, w],
                            warp_best[1][:, w])
    ex = torch.where(inside, torch.exp(val - best[:, None, None]),
                     torch.tensor(0.0))
    s, _ = tree(ex, ex, lambda a, _, b, __: (a + b, None))
    off = lanes // 2
    while off:
        s = s + s[:, lane ^ off]
        off //= 2
    total = s[:, 0]
    for w in range(1, g // lanes):
        total = total + s[:, w * lanes]
    probs = torch.zeros(rows, c)
    probs[:, cols[inside]] = (ex * torch.reciprocal(total)[:, None, None])[
        :, inside]
    return probs, best_i.to(torch.int32)


def _general_order(v):
    """The general kernel's order of work in torch (f32): thread t of the
    row's block walks columns t, t + 256, ... in order, the warps' bests
    by the shuffle tree and then in warp order; the sum the same way;
    each element exp / sum."""
    rows, c = v.shape
    k = -(-c // THREADS)
    cols = torch.arange(THREADS)[:, None] + THREADS * torch.arange(k)
    best = torch.full((rows, THREADS), float("-inf"))
    best_i = torch.full((rows, THREADS), c)
    for j in range(k):
        col = cols[:, j]
        x = v[:, col.clamp(max=c - 1)]
        keep = (col < c) & _better(x, col, best, best_i)
        best, best_i = _take(keep, x, best), _take(keep, col, best_i)
    lane = torch.arange(THREADS)
    for off in (16, 8, 4, 2, 1):
        ov, oi = best[:, lane ^ off], best_i[:, lane ^ off]
        keep = _better(ov, oi, best, best_i)
        best, best_i = _take(keep, ov, best), _take(keep, oi, best_i)
    bv, bi = best[:, 0], best_i[:, 0]
    for w in range(1, THREADS // WARP):
        keep = _better(best[:, w * WARP], best_i[:, w * WARP], bv, bi)
        bv = _take(keep, best[:, w * WARP], bv)
        bi = _take(keep, best_i[:, w * WARP], bi)
    part = torch.zeros(rows, THREADS)
    for j in range(k):
        col = cols[:, j]
        part = torch.where(col < c, part + torch.exp(
            v[:, col.clamp(max=c - 1)] - bv[:, None]), part)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lane ^ off]
    total = torch.zeros(rows)
    for w in range(THREADS // WARP):
        total = total + part[:, w * WARP]
    return torch.exp(v - bv[:, None]) / total[:, None], bi.to(torch.int32)


def _planted(rows, c, seed):
    """Logits with what the contract pins, as far as the shape holds it:
    ties at a row's maximum (the first index wins), a row of equal
    values, a −inf column (p = 0), a row that is −inf throughout (its
    probabilities NaN, its argmax 0), and a row whose second half is NaN
    (a NaN is the maximum: the first NaN wins)."""
    v = np.random.default_rng(seed).normal(0, 3, (rows, c)).astype(
        np.float32)
    if c >= 6:
        v[0, 5] = v[0, 2] = v[0].max() + 1.0
    if rows > 1:
        v[1, :] = 0.5
    if rows > 2 and c > 3:
        v[2, 3] = -np.inf
    if rows > 3:
        v[3, -1] = v[3, 0] = v[3].max() + 2.0
    if rows > 4:
        v[4, :] = -np.inf
    if rows > 5:
        v[5, c // 2:] = np.nan
    if rows > 2 and c == 1:
        v[2, 0] = np.nan
    return v


@pytest.mark.parametrize("rows,c", [
    (16, 8),     # the serving buckets and the sequence stack: 4 rows a warp
    (128, 1000),  # the AlexNet head: 8 warps a row
    (5, 1),      # one class: a thread a row
    (3, 33),     # two warps a row, most of the second one padding
    (7, 1024),   # the register route's widest row
    (2, 1025),   # one past it: the general route
])
@pytest.mark.parametrize("vec", [True, False])
def test_kernel_order_matches_pallas_kernel(rows, c, vec):
    """The order of work of the kernel :func:`fk.softmax_route` picks
    (:func:`_register_order`, its 128-bit layout with ``vec`` where it
    has one, or :func:`_general_order`), emulated in torch on the CPU,
    against the reference's Pallas ``_softmax_argmax_kernel`` in
    interpret mode: the probabilities within ``PROB_TOL`` where they are
    finite and NaN where the reference's are, the argmax exactly."""
    v = _planted(rows, c, seed=rows * c)
    want_p, want_i = pallas_kernels.softmax_argmax(jnp.asarray(v),
                                                   interpret=True)
    want_p, want_i = np.asarray(want_p), np.asarray(want_i)
    tv = torch.from_numpy(v)
    if fk.softmax_route(c) == "register":
        p, i = _register_order(tv, vec)
    else:
        p, i = _general_order(tv)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(np.isnan(p.numpy()), np.isnan(want_p))
    np.testing.assert_allclose(p.numpy(), want_p, rtol=0, atol=PROB_TOL)
    if rows > 5 and c > 1:
        assert int(i[5]) == c // 2 and int(i[4]) == 0
    if rows > 2 and c > 3:
        assert float(p[2, 3]) == 0.0
    if c >= 6:
        assert int(i[0]) == 2
