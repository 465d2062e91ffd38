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

The CUDA kernels cannot run here, so the register kernels' order of
work (which warp takes which row, how a lane's column sums run across
its rows, the fold within a block and over blocks) is emulated in torch
and held to the same references at the same tolerances; its γ/β sums
are pinned bitwise to a scalar walk of the documented order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_rule(dtype):
    """Which kernel a call takes on the card (:func:`fk.layer_norm_route`),
    from the width and the operands' addresses: the sequence stack's
    D = 512 and every multiple of 8 from 8 to 1024 take the register
    kernels; a width that is not a multiple of 8 or past 1024, or an
    operand off a 16-byte boundary, take the general ones."""
    def route(d, *tensors):
        return fk.layer_norm_route(d, *(t.data_ptr() for t in tensors))

    x = torch.empty(21, 512, dtype=dtype)
    g = torch.empty(512)
    assert route(512, x, torch.empty_like(x), g, torch.empty(512)) \
        == "register"
    for d in (8, 64, 520, fk.LN_REGISTER_MAX_WIDTH):
        assert route(d, torch.empty(3, d, dtype=dtype)) == "register"
    for d in (0, 4, 100, 513, fk.LN_REGISTER_MAX_WIDTH + 8, 4096):
        assert route(d, torch.empty(3, max(d, 1), dtype=dtype)) == "general"
    # a view one element off a 16-byte boundary, and one 16 bytes off
    flat = torch.empty(21 * 512 + 16, dtype=dtype)
    per16 = 16 // flat.element_size()
    off = flat[1:1 + 21 * 512].view(21, 512)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert route(512, off, g) == "general"
    assert route(512, x, off, g) == "general"
    assert route(512, flat[per16:per16 + 21 * 512].view(21, 512), g) \
        == "register"


#: the register kernels of csrc/layer_norm_fwd.cu and layer_norm_bwd.cu:
#: a warp of 32 lanes a row, 8-element vectors, 8 warps a block; the
#: backward's most blocks and its fold's warps
WARP, VEC, REG_WARPS, REG_BLOCKS, FOLD_WARPS = 32, 8, 8, 264, 32


def _lanes(a):
    """(R, D) → (R, 32, NV, 8), lane l's vector k the row's vector
    l + 32 k (zeros past the row), and own (32, NV): which of them lie
    in the row."""
    rows, d = a.shape
    vecs = d // VEC
    nv = -(-vecs // WARP)
    lanes = F.pad(a.float(), (0, nv * WARP * VEC - d)).reshape(
        rows, nv, WARP, VEC).transpose(1, 2)
    own = (torch.arange(WARP)[:, None] + WARP * torch.arange(nv)) < vecs
    return lanes, own


def _columns(lanes, d):
    """The inverse of :func:`_lanes`: (..., 32, NV, 8) → (..., D)."""
    *lead, _, nv, _ = lanes.shape
    return lanes.transpose(-3, -2).reshape(*lead, nv * WARP * VEC)[..., :d]


def _row_sum(terms, own):
    """A row sum as a warp takes it: each lane adds its terms vector by
    vector, element by element, then ``warp_sum``'s butterfly (xor 16,
    8, 4, 2, 1).  (R, 32, NV, 8) → (R,)."""
    s = torch.zeros(terms.shape[:2])
    for k in range(terms.shape[2]):
        for j in range(VEC):
            s = torch.where(own[:, k], s + terms[:, :, k, j], s)
    lane = torch.arange(WARP)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    return s[:, 0]


def _statistics(v, own, d):
    """``(x − μ, rstd)`` of the rows in lane layout, two passes over the
    registers as the kernels take them."""
    c = v - (_row_sum(v, own) / d)[:, None, None, None]
    rstd = torch.rsqrt(_row_sum(c * c, own) / d + EPS)
    return c, rstd[:, None, None, None]


def _fwd_register_order(x, gamma, beta, blocks):
    """The forward register kernel's order of work in torch (f32 math on
    the stored values): ``blocks`` persistent blocks of 8 warps, warp gw
    taking rows gw, gw + G, ... (G warps in all), each row from its
    lanes' registers.  Returns y (m, d) in f32; a row no warp took stays
    NaN."""
    m, d = x.shape
    v, own = _lanes(x)
    g = _lanes(gamma[None])[0]
    b = _lanes(beta[None])[0] if beta is not None else None
    y = torch.full(v.shape, float("nan"))
    warps = blocks * REG_WARPS
    for step in range(-(-m // warps)):
        rows = torch.arange(warps) + step * warps
        rows = rows[rows < m]
        c, rstd = _statistics(v[rows], own, d)
        out = c * rstd * g
        y[rows] = out + b if b is not None else out
    return _columns(y, d)


def _reg_blocks(m):
    """``(blocks, rows a block)`` of the backward register kernel, as
    ``reg_blocks`` in csrc/layer_norm_bwd.cu takes them."""
    if m <= 0:
        return 0, 0
    n = min(-(-m // REG_WARPS), REG_BLOCKS)
    per = -(-m // n)
    return -(-m // per), per


def _bwd_rows(x, err, gamma):
    """The backward register kernel's work on each row, from its lanes'
    registers: dx (f32) and the column terms ``err·x̂`` and ``err``, in
    lane layout."""
    d = x.shape[1]
    v, own = _lanes(x)
    e = _lanes(err)[0]
    g = _lanes(gamma[None])[0]
    c, rstd = _statistics(v, own, d)
    t = e * g
    mean_dxhat = (_row_sum(t, own) / d)[:, None, None, None]
    mean_dxhat_xhat = (_row_sum(t * c, own) / d)[:, None, None, None] * rstd
    xhat = c * rstd
    return (t - mean_dxhat - xhat * mean_dxhat_xhat) * rstd, [e * xhat, e]


def _walk_sums(terms):
    """One column sum of the backward, a scalar walk through the order the
    kernels document: in each block, each warp's rows in order, the warps
    in warp order; then the fold's warps over their ranges of blocks, in
    warp order.  terms: (m, d) f32 numpy; returns (d,) f32."""
    m, d = terms.shape
    n_blocks, per = _reg_blocks(m)
    work = []
    for b in range(n_blocks):
        acc = np.zeros(d, np.float32)
        for w in range(REG_WARPS):
            part = np.zeros(d, np.float32)
            for r in range(b * per + w, min((b + 1) * per, m), REG_WARPS):
                part = part + terms[r]
            acc = acc + part
        work.append(acc)
    q = -(-n_blocks // FOLD_WARPS)
    total = np.zeros(d, np.float32)
    for w in range(FOLD_WARPS):
        acc = np.zeros(d, np.float32)
        for i in range(w * q, min((w + 1) * q, n_blocks)):
            acc = acc + work[i]
        total = total + acc
    return total


def _bwd_register_order(x, err, gamma, with_beta, finish):
    """The backward register kernels' order of work in torch (f32 math on
    the stored values).  Block b owns rows [b·per, (b + 1)·per), warp w of
    it rows b·per + w + 8 i; a lane keeps its columns' ``err·x̂`` and
    ``err`` partials across its rows, in order; the blocks finish in the
    order ``finish`` and each folds its warps' partials in warp order
    into its workspace row; then the fold over blocks, warp w of it
    adding workspace rows [w·q, (w + 1)·q) in order and the warps' sums
    in warp order.  Returns (dx f32, grad_gamma, grad_beta or None)."""
    m, d = x.shape
    dx, terms = _bwd_rows(x, err, gamma)
    terms = terms[:2 if with_beta else 1]
    n_blocks, per = _reg_blocks(m)
    start = torch.arange(n_blocks)[:, None] * per
    end = torch.clamp(start + per, max=m)
    partials = [torch.zeros((n_blocks, REG_WARPS) + terms[0].shape[1:])
                for _ in terms]
    for i in range(-(-per // REG_WARPS)):
        rows = start + torch.arange(REG_WARPS) + REG_WARPS * i
        took = (rows < end)[..., None, None, None]
        r = rows.clamp(max=m - 1)
        partials = [torch.where(took, p + term[r], p)
                    for p, term in zip(partials, terms)]
    work = torch.full((len(terms), n_blocks, d), float("nan"))
    for blk in finish:
        for s, p in enumerate(partials):
            acc = torch.zeros(terms[0].shape[1:])
            for w in range(REG_WARPS):
                acc = acc + p[blk, w]
            work[s, blk] = _columns(acc, d)
    q = -(-n_blocks // FOLD_WARPS)
    sums = []
    for s in range(len(terms)):
        total = torch.zeros(d)
        for w in range(FOLD_WARPS):
            acc = torch.zeros(d)
            for i in range(w * q, min((w + 1) * q, n_blocks)):
                acc = acc + work[s, i]
            total = total + acc
        sums.append(total)
    return (_columns(dx, d), sums[0], sums[1] if with_beta else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("rows,d", [
    (1000, 64),    # 125 blocks of 8 rows: a row a warp
    (1031, 512),   # 129 blocks, the last one 7 rows short of 8
    (4261, 64),    # 251 blocks of 17 rows: 2-3 rows a warp, the last 11
    (1, 512),      # one row: one block, one warp
])
def test_register_kernel_order_matches_reference_kernel(dtype, with_beta,
                                                        rows, d):
    """The register kernels' order of work, emulated in torch on the CPU
    (:func:`_fwd_register_order`, :func:`_bwd_register_order`), against
    the reference's Pallas ``_ln_fwd_kernel`` / ``_ln_bwd_kernel`` in
    interpret mode, on the same stored values, at the file's tolerances
    (y and dx rounded to the stored dtype).  The γ/β sums have the bits
    of a scalar walk through the documented order (:func:`_walk_sums`)
    and do not depend on the order in which the blocks finish: two
    finishing orders give the same bits."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, g, b = _inputs((rows, d), seed=rows + d)
    err = np.random.default_rng(d).normal(0, 0.1, (rows, d)).astype(
        np.float32)
    tx, terr = (torch.from_numpy(a).to(tdt) for a in (x, err))
    tg, tb = torch.from_numpy(g), torch.from_numpy(b) if with_beta else None
    jx, jerr = (jnp.asarray(a.float().numpy()).astype(jdt)
                for a in (tx, terr))

    want_y = np.asarray(ref_ln(jx, jnp.asarray(g),
                               jnp.asarray(b) if with_beta else None, EPS,
                               interpret=True).astype(jnp.float32))
    y = _fwd_register_order(tx, tg, tb, blocks=3).to(tdt).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(y, want_y, rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(y, want_y, rtol=2.0 ** -7, atol=0)

    want_dx, want_g, want_b = ref_ln_bwd(jx, jerr, jnp.asarray(g), EPS,
                                         with_beta=with_beta, interpret=True)
    n_blocks = _reg_blocks(rows)[0]
    dx, grad_g, grad_b = _bwd_register_order(tx, terr, tg, with_beta,
                                             range(n_blocks))
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    dx_tol = 1e-6 if dtype == "float32" else \
        2.0 ** -7 * np.abs(want_dx).max()
    np.testing.assert_allclose(dx.to(tdt).float().numpy(), want_dx, rtol=0,
                               atol=dx_tol)
    xf, ef = tx.float(), terr.float()
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, unbiased=False, keepdim=True) + EPS)
    for got, want, terms in ((grad_g, want_g, ef * xhat),
                             (grad_b, want_b, ef)):
        if not with_beta and want is None:
            assert got is None
            continue
        bound = 1e-5 * terms.abs().sum(0).numpy()
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)
    finish = torch.randperm(n_blocks,
                            generator=torch.Generator().manual_seed(rows))
    again = _bwd_register_order(tx, terr, tg, with_beta, finish.tolist())
    for a, b_ in zip((grad_g, grad_b), again[1:]):
        assert (a is None) == (b_ is None)
        assert a is None or torch.equal(a, b_)
    terms = _bwd_rows(tx, terr, tg)[1]
    for got, term in zip((grad_g, grad_b), terms):
        if got is not None:
            np.testing.assert_array_equal(
                got.numpy(), _walk_sums(_columns(term, d).numpy()))


def test_route_rule_names_no_width_limit():
    """Past the register kernels' 1024 the general kernels take every
    width: the route rule names none, and the wrapper no longer refuses
    a width (on the CPU it takes the plain version at any width)."""
    for d in (1032, 25608, 51208, 10 ** 6 + 1):
        assert fk.layer_norm_route(d, 0, 16, 32) == "general"
    x, g, _ = (torch.from_numpy(a) for a in _inputs((3, 25608), seed=8))
    dx, grad_g, grad_b = fk.layer_norm_backward(x, x * 0.1, g, EPS)
    assert dx.shape == x.shape and grad_g.shape == grad_b.shape == (25608,)


#: the general kernels of csrc/layer_norm_bwd.cu: 8 warps a block, at most
#: 1024 blocks and 2^23 workspace floats, 32 rows' statistics a block at
#: once, 512 columns' partial sums at once
GEN_WARPS, GEN_MAX_BLOCKS, GEN_WORK_FLOATS = 8, 1024, 2 ** 23
GEN_GROUP, GEN_CHUNK = 32, 512


def _gen_blocks(m, d, with_beta, work_floats=GEN_WORK_FLOATS):
    """``(blocks, rows a block)`` of the general kernels, as
    ``gen_blocks`` in csrc/layer_norm_bwd.cu takes them."""
    if m <= 0:
        return 0, 0
    n = min(-(-m // GEN_WARPS), GEN_MAX_BLOCKS)
    fit = work_floats // (d * (2 if with_beta else 1))
    if n > fit:
        n = max(fit, 1)
    per = -(-m // n)
    return -(-m // per), per


def _bwd_general_order(x, err, gamma, with_beta, chunk=GEN_CHUNK,
                       group=GEN_GROUP, work_floats=GEN_WORK_FLOATS):
    """The general kernels' order of work in torch (f32 math on the
    stored values).  Block b owns rows [b·per, (b + 1)·per) and takes
    them in groups of ``group``: the group's row statistics first, then
    the columns ``chunk`` at a time, warp w computing dx of the group's
    rows w, w + 8, ... over the chunk and adding their ``err·x̂`` and
    ``err`` terms into its partial row in row order; the block adds its
    warps' rows in warp order and writes the chunk of its workspace row
    (the first group) or adds to it (the later ones, in group order);
    the fold adds the workspace rows in block order.  Returns (dx f32
    with NaN where nothing wrote, grad_gamma, grad_beta or None)."""
    m, d = x.shape
    xf, ef = x.float(), err.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + EPS)
    dxhat = ef * gamma
    mean_dxhat = dxhat.mean(-1, keepdim=True)
    mean_dxhat_xhat = (dxhat * (xf - mu)).mean(-1, keepdim=True) * rstd
    n_sums = 2 if with_beta else 1
    n_blocks, per = _gen_blocks(m, d, with_beta, work_floats)
    dx = torch.full((m, d), float("nan"))
    work = torch.full((n_sums, n_blocks, d), float("nan"))
    for b in range(n_blocks):
        row0, row1 = b * per, min((b + 1) * per, m)
        for g0 in range(row0, row1, group):
            rows = range(g0, min(g0 + group, row1))
            for c0 in range(0, d, chunk):
                cols = slice(c0, min(c0 + chunk, d))
                acc = torch.zeros(n_sums, GEN_WARPS, cols.stop - c0)
                for w in range(GEN_WARPS):
                    for r in rows[w::GEN_WARPS]:
                        xhat = (xf[r, cols] - mu[r]) * rstd[r]
                        dx[r, cols] = (dxhat[r, cols] - mean_dxhat[r]
                                       - xhat * mean_dxhat_xhat[r]) * rstd[r]
                        acc[0, w] = acc[0, w] + ef[r, cols] * xhat
                        if with_beta:
                            acc[1, w] = acc[1, w] + ef[r, cols]
                fold = torch.zeros(n_sums, cols.stop - c0)
                for w in range(GEN_WARPS):
                    fold = fold + acc[:, w]
                if g0 == row0:
                    work[:, b, cols] = fold
                else:
                    work[:, b, cols] = work[:, b, cols] + fold
    sums = torch.zeros(n_sums, d)
    for b in range(n_blocks):
        sums = sums + work[:, b]
    return dx, sums[0], sums[1] if with_beta else None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("rows,d,group,work_floats", [
    (70, 40, 4, GEN_WORK_FLOATS),  # 9 blocks of 8 rows, two groups each
    # the workspace cap: 3 blocks of 100 rows, 9 groups each, 1-2 rows a
    # warp in a group
    (300, 37, 12, 3 * 2 * 37),
    (5, 1030, 4, GEN_WORK_FLOATS),  # one block, a ragged last chunk
])
def test_general_kernel_order_matches_reference_kernel(dtype, with_beta,
                                                       rows, d, group,
                                                       work_floats):
    """The general kernels' order of work, emulated in torch on the CPU
    with a tiny chunk (16 columns) and group (4 or 12 rows) so that
    several of each run (:func:`_bwd_general_order`), against the
    reference's Pallas
    ``_ln_bwd_kernel`` in interpret mode, at the file's tolerances: every
    element of dx written once; and the sums' bits do not depend on the
    chunk width (each column's terms are added in the same order), so
    the kernel's 512 gives the same bits as 16."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, g, _ = _inputs((rows, d), seed=rows + d)
    err = np.random.default_rng(d).normal(0, 0.1, (rows, d)).astype(
        np.float32)
    tx, terr = (torch.from_numpy(a).to(tdt) for a in (x, err))
    tg = torch.from_numpy(g)
    jx, jerr = (jnp.asarray(a.float().numpy()).astype(jdt)
                for a in (tx, terr))
    want_dx, want_g, want_b = ref_ln_bwd(jx, jerr, jnp.asarray(g), EPS,
                                         with_beta=with_beta, interpret=True)
    dx, grad_g, grad_b = _bwd_general_order(tx, terr, tg, with_beta,
                                            chunk=16, group=group,
                                            work_floats=work_floats)
    assert not bool(torch.isnan(dx).any())
    want_dx = np.asarray(want_dx.astype(jnp.float32))
    dx_tol = 1e-6 if dtype == "float32" else \
        2.0 ** -7 * np.abs(want_dx).max()
    np.testing.assert_allclose(dx.to(tdt).float().numpy(), want_dx, rtol=0,
                               atol=dx_tol)
    xf, ef = tx.float(), terr.float()
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, unbiased=False, keepdim=True) + EPS)
    for got, want, terms in ((grad_g, want_g, ef * xhat),
                             (grad_b, want_b, ef)):
        if not with_beta and want is None:
            assert got is None
            continue
        bound = 1e-5 * terms.abs().sum(0).numpy()
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)
    wide = _bwd_general_order(tx, terr, tg, with_beta, group=group,
                              work_floats=work_floats)
    assert torch.equal(wide[0], dx)
    for a, b_ in zip((grad_g, grad_b), wide[1:]):
        assert a is None or torch.equal(a, b_)
