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
import torch.nn.functional as F

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_rule(dtype):
    """Which kernel a call takes on the card (:func:`fk.lrn_route`), from
    the channel count and the operands' addresses: AlexNet's two shapes
    take the vector kernels; a channel count that is not a multiple of 8
    or past 2048, or an operand off a 16-byte boundary, take the general
    ones, at any width."""
    def route(c, *tensors):
        return fk.lrn_route(c, *(t.data_ptr() for t in tensors))

    for c in (96, 256):  # after conv1 and conv2
        x = torch.empty(21, c, dtype=dtype)
        assert route(c, x, torch.empty_like(x)) == "vector"
        assert route(c, x, x, torch.empty_like(x)) == "vector"
    x = torch.empty(4, fk.LRN_VECTOR_MAX_CHANNELS, dtype=dtype)
    assert route(x.shape[1], x) == "vector"
    assert route(8, x) == "vector"
    assert route(37, x) == "general"  # chip_smoke's odd_ragged
    assert route(fk.LRN_VECTOR_MAX_CHANNELS + 8, x) == "general"
    assert route(16384, x) == "general"
    # a view one element off a 16-byte boundary, and one 16 bytes off
    flat = torch.empty(21 * 96 + 16, dtype=dtype)
    per16 = 16 // flat.element_size()
    off = flat[1:1 + 21 * 96].view(21, 96)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert route(96, flat, off) == "general"
    assert route(96, flat[per16:per16 + 21 * 96].view(21, 96)) == "vector"
    # the general kernels tile the channels: no width is refused
    for c in (16392, 2 ** 20 + 3):
        assert fk.lrn_route(c, x.data_ptr()) == "general"


#: the vector kernels' block (csrc/lrn.cu) and the window whose halos
#: they keep in registers
THREADS, REGISTER_WINDOW = 256, 5


def _vector_windows(own, staged, c, lo, hi, in_registers):
    """``window_sums`` of ``csrc/lrn.cu`` for every thread of every tile:
    own (tiles, THREADS, V) the thread's values, staged (tiles, V,
    THREADS) the tile's values as the threads wrote them (element e of
    vector v at [e, v]); each sum added in channel order over
    [i − lo, i + hi], a channel outside the row adding 0.  With
    ``in_registers`` the terms in the thread's own vector come from own
    and the halos from staged; otherwise a window of V terms, first read
    from staged at tap −lo, slides one channel a tap and reads its one
    new term from staged."""
    v = fk.LRN_VECTOR
    vec = torch.arange(THREADS)
    c0 = (vec % (c // v)) * v
    zero = torch.zeros(own.shape[:2])

    def value(o):  # channel c0 + o: element o mod V of vector o div V
        if in_registers and 0 <= o < v:
            return own[..., o]
        near = staged[:, o % v, (vec + o // v).clamp(0, THREADS - 1)]
        return torch.where((c0 + o >= 0) & (c0 + o < c), near, zero)

    sums = [zero] * v
    if in_registers:
        for j in range(-lo, hi + 1):
            sums = [sums[i] + value(i + j) for i in range(v)]
        return torch.stack(sums, -1)
    w = [value(i - lo) for i in range(v)]
    for j in range(-lo, hi + 1):
        sums = [sums[i] + w[i] for i in range(v)]
        w = w[1:] + [value(v + j)]
    return torch.stack(sums, -1)


def _vector_kernel_order(x, err, alpha, beta, k, n):
    """The vector kernels' order of work in torch, f32 math on the stored
    values: 256 threads a tile of whole rows, V = 8 channels a thread,
    the squares staged and the window summed by :func:`_vector_windows`;
    the backward keeps err·d^(−β) and stages t for the adjoint window.
    Returns (y, dx) in f32."""
    v = fk.LRN_VECTOR
    rows, c = x.shape
    per_tile = THREADS // (c // v)
    tiles = -(-rows // per_tile)
    lo, hi = n // 2, n - 1 - n // 2
    regs = n == REGISTER_WINDOW

    def own(a):  # (rows, c) → (tiles, THREADS, V); no thread past the rows
        a = F.pad(a.float(), (0, 0, 0, tiles * per_tile - rows))
        a = a.reshape(tiles, per_tile * c // v, v)
        return F.pad(a, (0, 0, 0, THREADS - per_tile * c // v))

    def back(a):
        return a[:, :per_tile * c // v].reshape(-1, c)[:rows]

    f32 = torch.float32
    alpha_, beta_, k_ = (torch.tensor(a, dtype=f32) for a in (alpha, beta, k))
    xv, ev = own(x), own(err)
    sq = xv * xv
    sums = _vector_windows(sq, sq.transpose(1, 2), c, lo, hi, regs)
    d = k_ + alpha_ * sums
    p = fk._pow_neg(d, beta)
    y = xv * p
    t = ev * xv * (p / d)
    adj = _vector_windows(t, t.transpose(1, 2), c, hi, lo, regs)
    dx = ev * p - 2.0 * alpha_ * beta_ * xv * adj
    return back(y), back(dx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c,n", [
    (40, 96, 5),    # conv1's width: 21 rows a tile, the second one short
    (40, 96, 4),    # an even window: its adjoint differs
    (40, 96, 3),
    (20, 256, 5),   # conv2's width: 8 rows a tile
    (20, 256, 4),
    (9, 8, 5),      # one vector a row
    (9, 8, 3),
    (33, 32, 19),   # any n: the sliding window, two vectors away
    (30, 24, 2),
])
def test_vector_kernel_order_matches_reference_kernel(dtype, rows, c, n):
    """The vector kernels' order of work, emulated in torch on the CPU
    (:func:`_vector_kernel_order`), against the reference's Pallas
    ``lrn_forward``/``lrn_backward`` in interpret mode, on the same
    stored values: the file's ``F32_TOL``, or one bf16 step where y and
    dx are stored in bf16.  The emulation's f32 results also match the
    port's plain versions: the same terms in the same order."""
    tdt = getattr(torch, dtype)
    cfg = dict(ALEXNET, n=n)
    x = torch.from_numpy(_x(rows, c, seed=rows + c + n)).to(tdt)
    err = torch.from_numpy(np.random.default_rng(n).normal(
        0, 1, (rows, c)).astype(np.float32)).to(tdt)
    want_y = np.asarray(pallas_kernels.lrn_forward(
        jnp.asarray(x.float().numpy()), interpret=True, **cfg))
    want_dx = np.asarray(pallas_kernels.lrn_backward(
        jnp.asarray(x.float().numpy()), jnp.asarray(err.float().numpy()),
        interpret=True, **cfg))
    y, dx = _vector_kernel_order(x, err, **cfg)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(y.to(tdt).float(), want_y) <= tol
    assert _rel(dx.to(tdt).float(), want_dx) <= tol
    plain_y = fk.lrn_forward_plain(x.float(), **cfg)
    plain_dx = fk.lrn_backward_plain(x.float(), err.float(), **cfg)
    assert _rel(y, plain_y.numpy()) <= F32_TOL
    assert _rel(dx, plain_dx.numpy()) <= F32_TOL


#: the general kernels of csrc/lrn.cu: elements a block owns, and values a
#: staging buffer holds
GEN_TILE, GEN_STAGE = 4 * 256, 2048


def _reach(e0, e1, c, lo, hi):
    """``reach`` of csrc/lrn.cu: the elements the windows [e − lo, e + hi]
    of elements e0..e1 of the flat (rows·C) array reach, each cut to its
    own row."""
    first, last = e0 // c * c, e1 // c * c + c - 1
    return max(e0 - lo, first), min(e1 + hi, last)


def _add_staged(sums, e, staged, base, c, lo, hi):
    """``add_staged`` for elements ``e`` at once: each adds, in channel
    order, the staged terms of the part of its window (cut to its row)
    that lies in the chunk [base, base + len)."""
    row = e // c * c
    wa = torch.maximum(e - lo, row)
    wz = torch.minimum(e + hi, row + c - 1)
    for j in range(staged.numel()):
        inside = (base + j >= wa) & (base + j <= wz)
        sums = torch.where(inside, sums + staged[j], sums)
    return sums


def _general_kernel_order(x, err, alpha, beta, k, n, tile=GEN_TILE,
                          stage=GEN_STAGE):
    """The general kernels' order of work in torch, f32 math on the
    stored values.  The (rows, C) array is one run of elements, a block
    owning ``tile`` of them.  Forward: the squares of the range the
    tile's windows reach are staged ``stage`` at a time and added to each
    element's window sum chunk by chunk.  Backward: the adjoint range of
    the tile is walked ``stage`` elements at a time; for each chunk the
    squares its forward windows reach are staged (chunk by chunk again)
    into its elements' forward sums, the chunk's t = err·x·d^(−β−1) and
    d^(−β) staged, and t added to the tile's adjoint sums.  Returns (y,
    dx) in f32."""
    rows, c = x.shape
    count = rows * c
    lo, hi = n // 2, n - 1 - n // 2
    f32 = torch.float32
    alpha_, beta_, k_ = (torch.tensor(a, dtype=f32) for a in (alpha, beta, k))
    xf, ef = x.float().reshape(-1), err.float().reshape(-1)
    sq = xf * xf
    y = torch.full((count,), float("nan"))
    dx = torch.full((count,), float("nan"))

    def forward_sums(e0, e1):  # the window sums of elements e0..e1
        e = torch.arange(e0, e1 + 1)
        sums = torch.zeros(e.numel())
        a, z = _reach(e0, e1, c, lo, hi)
        for base in range(a, z + 1, stage):
            sums = _add_staged(sums, e, sq[base:min(base + stage, z + 1)],
                               base, c, lo, hi)
        return k_ + alpha_ * sums

    for e0 in range(0, count, tile):
        e1 = min(e0 + tile, count) - 1
        e = torch.arange(e0, e1 + 1)
        d = forward_sums(e0, e1)
        y[e] = xf[e] * fk._pow_neg(d, beta)
        adj = torch.zeros(e.numel())
        p_own = torch.full((e.numel(),), float("nan"))
        ta, tz = _reach(e0, e1, c, hi, lo)
        for tb in range(ta, tz + 1, stage):
            te = min(tb + stage, tz + 1) - 1
            dj = forward_sums(tb, te)
            pj = fk._pow_neg(dj, beta)
            j = torch.arange(tb, te + 1)
            t = ef[j] * xf[j] * (pj / dj)
            adj = _add_staged(adj, e, t, tb, c, hi, lo)
            mine = (e >= tb) & (e <= te)
            p_own[mine] = pj[e[mine] - tb]
        dx[e] = ef[e] * p_own - 2.0 * alpha_ * beta_ * xf[e] * adj
    return y.reshape(rows, c), dx.reshape(rows, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c,n,tile,stage", [
    (5, 37, 5, 16, 8),     # tiles across rows, AlexNet's window
    (3, 40, 4, 16, 8),     # an even window: its adjoint differs
    (2, 70, 23, 32, 16),   # halos wider than a chunk: several chunks a tile
    (4, 9, 25, 8, 4),      # a window past both row ends
    (6, 1, 3, 4, 2),       # one channel
    (3, 50, 5, GEN_TILE, GEN_STAGE),  # the kernel's own tile and buffer
])
def test_general_kernel_order_matches_reference_kernel(dtype, rows, c, n,
                                                       tile, stage):
    """The general kernels' order of work, emulated in torch on the CPU
    with tiny tiles and staging buffers (:func:`_general_kernel_order`),
    against the reference's Pallas ``lrn_forward``/``lrn_backward`` in
    interpret mode on the same stored values, at the file's ``F32_TOL``
    or one bf16 step: windows cut to their rows at both ends, never
    wrapping into the next row, halos in several chunks.  In f32 the
    emulation's y has the plain version's bits (the same terms in the
    same order); its dx matches the plain version's to ``F32_TOL``, as
    the kernels round 2αβ in f32 where the plain version rounds it from
    a double."""
    tdt = getattr(torch, dtype)
    cfg = dict(ALEXNET, n=n)
    x = torch.from_numpy(_x(rows, c, seed=rows + c + n)).to(tdt)
    err = torch.from_numpy(np.random.default_rng(n).normal(
        0, 1, (rows, c)).astype(np.float32)).to(tdt)
    want_y = np.asarray(pallas_kernels.lrn_forward(
        jnp.asarray(x.float().numpy()), interpret=True, **cfg))
    want_dx = np.asarray(pallas_kernels.lrn_backward(
        jnp.asarray(x.float().numpy()), jnp.asarray(err.float().numpy()),
        interpret=True, **cfg))
    y, dx = _general_kernel_order(x, err, **cfg, tile=tile, stage=stage)
    assert not bool(torch.isnan(y).any() or torch.isnan(dx).any())
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(y.to(tdt).float(), want_y) <= tol
    assert _rel(dx.to(tdt).float(), want_dx) <= tol
    assert torch.equal(y, fk.lrn_forward_plain(x.float(), **cfg))
    plain_dx = fk.lrn_backward_plain(x.float(), err.float(), **cfg)
    assert _rel(dx, plain_dx.numpy()) <= F32_TOL
