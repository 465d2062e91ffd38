"""The port's flash attention against the reference's Pallas kernels.

The reference kernel (``znicz_tpu.ops.pallas_attention._fwd_kernel``)
runs in interpret mode on the CPU, reached through ``ring_hop`` (which
returns ``(out, lse)`` at global offsets) and the public
``flash_attention``.  The port's counterpart on the CPU is
:func:`znicz_tpu_torch.ops.flash_attention.flash_attention_plain`, the
plain version its kernel wrapper takes for CPU tensors; the CUDA kernel
itself is held to that plain version on the card by ``chip_smoke.py``.

The backward (``_dq_kernel`` and ``_dkv_kernel``, reached through
``jax.vjp`` of ``ring_hop`` with a nonzero lse cotangent) is held the
same way against :func:`~znicz_tpu_torch.ops.flash_attention.flash_attention_bwd_plain`
and against the autograd Function ``FlashHop``.

Tolerances: float32 operands 2e-5 (summation order only: the plain
version folds the whole key axis at once, the reference tile by tile);
bf16 operands 2e-2 (p is rounded to bf16 before the p·v product at the
running maximum in the reference and at the global maximum here, a
flip of one bf16 ulp of p).  Gradients, relative to the largest
|reference| of each: float32 5e-6 (summation order); bf16 1e-2 (p and
ds are rounded to bf16 before their products at f32 values that differ
in the last bits, which can flip one bf16 rounding of a term).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from znicz_tpu.ops import pallas_attention as ref
from znicz_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, tq, tk, h, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, tq, h, dh)).astype(np.float32),
            rng.normal(0, 1, (b, tk, h, dh)).astype(np.float32),
            rng.normal(0, 1, (b, tk, h, dh)).astype(np.float32))


def _ref_hop(q, k, v, causal, q_off, k_off, dtype, block):
    """Reference (out (B, Tq, H, dh) f32, lse (B, H, Tq)) through the
    Pallas kernel in interpret mode."""
    jdt = getattr(jnp, dtype)
    qh, kh, vh = (jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3)
                  for a in (q, k, v))
    out, lse = ref.ring_hop(qh, kh, vh, q_off, k_off, causal, block,
                            block, interpret=True)
    return (np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3),
            np.asarray(lse)[..., 0])


def _port_plain(q, k, v, causal, q_off, k_off, dtype):
    tdt = getattr(torch, dtype)
    out, lse = fa.flash_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal,
        q_off, k_off)
    assert out.dtype == tdt and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_off,k_off,tq,tk", [
    (False, 0, 0, 32, 32),
    (True, 0, 0, 32, 32),
    (False, 0, 0, 32, 64),        # cross lengths, several key tiles
    (True, 32, 0, 32, 64),        # the diagonal mid-way through the keys
    (True, 8, 24, 32, 32),        # rows 8..23 see no key: fully masked
])
def test_plain_matches_reference_kernel(dtype, causal, q_off, k_off, tq,
                                        tk):
    q, k, v = _qkv(1, tq, tk, 2, 16, seed=tq + tk + q_off)
    want_out, want_lse = _ref_hop(q, k, v, causal, q_off, k_off, dtype,
                                  block=16)
    got_out, got_lse = _port_plain(q, k, v, causal, q_off, k_off, dtype)
    np.testing.assert_allclose(got_out, want_out, rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-6,
                               atol=TOL[dtype])
    if causal and k_off > q_off:
        masked = q_off + np.arange(tq) < k_off
        # the reference's guard: out 0 and lse -1e30, never NaN
        assert np.all(got_out[:, masked] == 0.0)
        assert np.all(got_lse[:, :, masked] <= -1e29)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dot_dtype", [None, "bfloat16"])
def test_public_entry_matches_reference(causal, dot_dtype):
    """``flash_attention``: operands cast to ``dot_dtype``, out upcast
    to f32, as the reference's public entry does."""
    q, k, v = _qkv(2, 32, 32, 2, 16, seed=11)
    want = ref.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, block_q=16,
        block_k=16, interpret=True,
        dot_dtype=None if dot_dtype is None else jnp.bfloat16)
    got = fa.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        dot_dtype=None if dot_dtype is None else torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL[dot_dtype or "float32"])


def test_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 16, 16, 2, 64, seed=3))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert out.shape == (1, 16, 2, 64) and lse.shape == (1, 2, 16)
    # the counter counts kernel launches, and the CPU launched none
    assert fa.flash_attention_fwd.launches == before
    # a device that is neither the CPU nor CUDA is refused, not served
    meta = [a.to("meta") for a in (q, k, v)]
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(*meta)


def test_wrapper_checks_shapes():
    q = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention_fwd(q, torch.zeros(1, 16, 4, 32),
                               torch.zeros(1, 16, 4, 32))
    with pytest.raises(ValueError, match="dtypes differ"):
        fa.flash_attention_fwd(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match=r"\(B, T, H, dh\)"):
        fa.flash_attention_fwd(q[0], q[0], q[0])


def test_strided_views_of_a_packed_projection_match_contiguous():
    """The attention unit hands the kernel strided q/k/v views of one
    (B, T, 3·D) projection; the result must not depend on the
    layout."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, 16, 3 * 32))
                           .astype(np.float32))
    views = [qkv[..., i * 32:(i + 1) * 32].view(2, 16, 2, 16)
             for i in range(3)]
    got, _ = fa.flash_attention_fwd(*views, causal=True)
    want, _ = fa.flash_attention_fwd(*(a.contiguous() for a in views),
                                     causal=True)
    assert torch.equal(got, want)


#: gradient tolerance relative to max |reference gradient|
BWD_TOL = {"float32": 5e-6, "bfloat16": 1e-2}


def _ref_hop_grads(q, k, v, dout, dlse, causal, q_off, k_off, dtype):
    """dq, dk, dv (B, T, H, dh) f32 from ``jax.vjp`` of the reference
    hop in interpret mode, with cotangents ``dout`` and ``dlse``."""
    jdt = getattr(jnp, dtype)
    qh, kh, vh = (jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3)
                  for a in (q, k, v))
    _, pullback = jax.vjp(
        lambda a, b, c: ref.ring_hop(a, b, c, q_off, k_off, causal, 16, 16,
                                     interpret=True), qh, kh, vh)
    grads = pullback((jnp.asarray(dout).astype(jdt).transpose(0, 2, 1, 3),
                      jnp.asarray(dlse)[..., None]))
    return [np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3)
            for g in grads]


#: (causal, q_off, k_off, tq, tk, dh, dtypes).  At dh 16 in both dtypes:
#: square, cross lengths with the diagonal mid-keys, and rows 8..23 fully
#: masked.  Then f32 cases at the edges of the f32 backward kernel's tiles
#: (64 rows, 32-column slices of the head dim): lengths that the
#: reference's blocks of 16 take but that are no multiple of 64, causal
#: offsets that leave a partial tile, and head dims 8 and 40 (zero-padded
#: to 32 and 64 on the card).
_BWD_CASES = (
    (False, 0, 0, 32, 32, 16, ("float32", "bfloat16")),
    (True, 32, 0, 32, 64, 16, ("float32", "bfloat16")),
    (True, 8, 24, 32, 32, 16, ("float32", "bfloat16")),
    (False, 0, 0, 48, 80, 8, ("float32",)),
    (False, 0, 0, 80, 48, 40, ("float32",)),
    (True, 40, 8, 80, 48, 40, ("float32",)),
    (True, 16, 40, 48, 80, 8, ("float32",)),
)


@pytest.mark.parametrize("dtype,causal,q_off,k_off,tq,tk,dh", [
    pytest.param(dtype, causal, q_off, k_off, tq, tk, dh,
                 id="-".join(map(str, (causal, q_off, k_off, tq, tk)))
                 + ("" if dh == 16 else f"-dh{dh}") + f"-{dtype}")
    for causal, q_off, k_off, tq, tk, dh, dtypes in _BWD_CASES
    for dtype in dtypes])
def test_backward_matches_reference_kernels(dtype, causal, q_off, k_off,
                                            tq, tk, dh):
    q, k, v = _qkv(1, tq, tk, 2, dh, seed=tq + tk + q_off)
    rng = np.random.default_rng(q_off + 100)
    dout = rng.normal(0, 1, q.shape).astype(np.float32)
    dlse = rng.normal(0, 1, (1, 2, tq)).astype(np.float32)
    want = _ref_hop_grads(q, k, v, dout, dlse, causal, q_off, k_off, dtype)
    tdt = getattr(torch, dtype)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tdo, tdl = torch.from_numpy(dout).to(tdt), torch.from_numpy(dlse)
    out, lse = fa.flash_attention_plain(tq_, tk_, tv_, causal, q_off, k_off)
    plain = fa.flash_attention_bwd_plain(tq_, tk_, tv_, out, lse, tdo, tdl,
                                         causal, q_off, k_off)
    leaves = [a.clone().requires_grad_() for a in (tq_, tk_, tv_)]
    o, l = fa.FlashHop.apply(*leaves, causal, q_off, k_off)
    torch.autograd.backward([o, l], [tdo, tdl])
    for name, w, got, through_fn in zip("qkv", want, plain,
                                        (a.grad for a in leaves)):
        assert got.dtype == tdt and got.shape == w.shape, name
        atol = BWD_TOL[dtype] * np.abs(w).max()
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=atol, err_msg=f"d{name} plain")
        np.testing.assert_allclose(through_fn.float().numpy(), w, rtol=0,
                                   atol=atol, err_msg=f"d{name} FlashHop")


def test_lse_cotangent_enters_the_gradient():
    """A nonzero lse cotangent moves dq and dk (it folds into delta);
    without it the Function's gradient is the out-only one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 2, 16, seed=8))
    dout = torch.ones(1, 16, 2, 16)
    out, lse = fa.flash_attention_plain(q, k, v)
    no_lse = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    with_lse = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                            torch.ones(1, 2, 16))
    assert not torch.allclose(no_lse[0], with_lse[0])
    assert torch.equal(no_lse[2], with_lse[2])  # dv does not see delta
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    fa.flash_attention(*leaves).backward(dout)
    for got, want in zip((a.grad for a in leaves), no_lse):
        assert torch.equal(got, want)


def test_backward_wrappers_take_the_plain_version_for_cpu_tensors_only():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 16, 16, 2, 64, seed=4))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True)
    dout = torch.ones_like(out)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    before = (fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    args = (q, k, v, dout, lse, delta, True)
    assert torch.equal(fa.flash_attention_dq(*args),
                       fa.flash_attention_dq_plain(*args))
    for got, want in zip(fa.flash_attention_dkv(*args),
                         fa.flash_attention_dkv_plain(*args)):
        assert torch.equal(got, want)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before
    meta = [a.to("meta") for a in args[:6]]
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_dq(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_dkv(*meta)
    with pytest.raises(ValueError, match="must be f32"):
        fa.flash_attention_dq(q, k, v, dout, lse[:, :1], delta)


def test_every_kernel_source_is_built_and_named():
    """Every ``csrc/*.cu`` is in ``_cuda.SOURCES`` (so it is built and
    hashed), and every library stem the flash wrappers load is one of
    them."""
    from znicz_tpu_torch.ops import _cuda
    assert sorted(_cuda.SOURCES) == sorted(
        path.name for path in _cuda.CSRC.glob("*.cu"))
    stems = {name[:-len(".cu")] for name in _cuda.SOURCES}
    for fwd, bwd, _ in fa._LIBS.values():
        assert {fwd, bwd} <= stems
    assert fa._LIBS[torch.float32][1] == "flash_attention_bwd_f32"


def test_f32_backward_operands_get_16_byte_rows():
    """The f32 backward copies its operands 16 bytes at a time: a view
    whose base or row stride is off a 16-byte boundary is copied, an
    aligned one (a packed projection's slice) is passed as it is."""
    packed = torch.zeros(2, 8, 3 * 64)
    aligned = packed[..., 64:128].view(2, 8, 2, 32)
    assert fa._rows_aligned(aligned) is aligned
    for off in (packed[..., 1:65].view(2, 8, 2, 32),
                torch.zeros(2, 8, 2, 33)[..., :32]):
        got = fa._rows_aligned(off)
        assert got is not off and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, off)


def test_head_dim_routing_is_the_reference_rule():
    """The reference engages its kernel when ``dh % 8 == 0``, at any
    width; so do the port's kernels.  The f32 kernels are instantiated
    at 32, 64, 128 and 256 and take any other multiple of 8 up to 256
    zero-padded to the next of them (C2); past 256 the streamed kernels
    take it padded to a multiple of their 128-column output chunk (C5).
    A head dim that is no multiple of 8 goes to the plain core."""
    assert [d for d in range(1, 600) if fa.kernel_legal(d)] == \
        list(range(8, 600, 8))
    assert [fa.kernel_head_dim(d) for d in
            (8, 32, 40, 64, 72, 96, 128, 136, 200, 256, 264, 384, 392,
             512)] \
        == [32, 32, 64, 64, 128, 128, 128, 256, 256, 256, 384, 384, 512,
            512]
    for dh in (4, 12):
        assert not fa.kernel_legal(dh)
        with pytest.raises(ValueError, match="multiples of 8, got"):
            fa.kernel_head_dim(dh)


@pytest.mark.parametrize("dtype,dh,match", [
    ("float32", 32, "unsupported device"),   # f32 operands are taken
    ("bfloat16", 40, "unsupported device"),  # padded to 64
    ("float16", 64, "operands"),
    ("bfloat16", 4, "multiples of 8"),
    ("float32", 136, "unsupported device"),  # padded to 256 (C2)
    ("bfloat16", 200, "unsupported device"),
    ("bfloat16", 256, "unsupported device"),
    ("float32", 264, "unsupported device"),  # padded to 384 (C5)
    ("bfloat16", 512, "unsupported device"),
])
def test_kernel_entry_takes_f32_and_multiples_of_8(dtype, dh, match):
    """On a device that is not the CPU the wrappers check what the
    kernels take before the device: f32 and bf16, dh any multiple of
    8."""
    q = torch.zeros(1, 8, 2, dh, dtype=getattr(torch, dtype), device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_dq(q, q, q, q, lse, lse)


@pytest.mark.parametrize("dot_dtype", [None, "bfloat16"])
def test_core_routes_dh4_to_the_plain_core_as_the_reference(monkeypatch,
                                                            dot_dtype):
    """dh = 4: the reference's XLA core (``local_attention``) in both
    packages, forward and gradient; no kernel wrapper is reached.
    dh = 32: the flash kernels' route."""
    from znicz_tpu.parallel.ring_attention import local_attention
    jdt = None if dot_dtype is None else jnp.bfloat16
    tdt = None if dot_dtype is None else torch.bfloat16
    q, k, v = _qkv(2, 12, 12, 3, 4, seed=17)
    dout = np.random.default_rng(18).normal(0, 1, q.shape).astype(np.float32)
    want, pullback = jax.vjp(
        lambda a, b, c: local_attention(a, b, c, causal=True, dot_dtype=jdt),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = pullback(jnp.asarray(dout))

    def no_kernel(*args, **kwargs):
        raise AssertionError("dh = 4 reached the flash route")

    monkeypatch.setattr(fa, "flash_attention", no_kernel)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = fa.attention_core(tq, tk, tv, causal=True, dot_dtype=tdt)
    got.backward(torch.from_numpy(dout))
    tol = TOL[dot_dtype or "float32"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())
    q32 = torch.zeros(1, 8, 2, 32)
    with pytest.raises(AssertionError, match="flash route"):
        fa.attention_core(q32, q32, q32)


def _meta(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("make,problem", [
    # the head dim not contiguous
    (lambda: _meta(1, 8, 2, 64, 2)[..., 0], "the head dim is not contiguous"),
    # a base 2 bytes past a 16-byte boundary
    (lambda: _meta(1, 8, 2, 72)[..., 1:65], "the base address"),
    # heads 68 elements (136 bytes) apart
    (lambda: _meta(1, 8, 2, 68)[..., :64], "byte strides"),
    # time steps 132 elements apart: 264 bytes
    (lambda: _meta(1, 8, 132)[..., :128].view(1, 8, 2, 64), "byte strides"),
])
def test_forward_checks_tma_preconditions_before_the_device(make, problem):
    """The bf16 forward reads through TMA tensor maps: a layout TMA
    cannot describe raises, naming the precondition, before any device
    work (on ``meta`` it would otherwise reach "unsupported device")."""
    bad, good = make(), _meta(1, 8, 2, 64)
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match=f"TMA cannot read this "
                                             f"operand: {problem}"):
            fa.flash_attention_fwd(*args)
    # the packed-QKV views the attention unit passes are legal
    qkv = _meta(2, 8, 3 * 2 * 40)
    views = [qkv[..., i * 80:(i + 1) * 80].view(2, 8, 2, 40)
             for i in range(3)]
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(*views)


@pytest.mark.parametrize("dh", [200, 256, 264, 512])
@pytest.mark.parametrize("causal,q_off,k_off,tq,tk", [
    (False, 0, 0, 32, 32),
    (True, 32, 0, 32, 64),        # cross lengths, the diagonal mid-keys
    (True, 8, 24, 32, 32),        # rows 8..23 fully masked
])
def test_plain_matches_reference_kernels_past_128(dh, causal, q_off, k_off,
                                                  tq, tk):
    """Head dims past 128 (C2) and past 256 (C5): the plain forward and
    backward, which the kernels are held to on the card, against the
    reference's Pallas kernels, in bf16: at 256, at a 200 the f32
    kernels pad to 256, and at 264 and 512, which the streamed kernels
    take (the f32 ones 264 padded to 384)."""
    q, k, v = _qkv(1, tq, tk, 2, dh, seed=dh + tq + q_off)
    want_out, want_lse = _ref_hop(q, k, v, causal, q_off, k_off,
                                  "bfloat16", block=16)
    got_out, got_lse = _port_plain(q, k, v, causal, q_off, k_off,
                                   "bfloat16")
    np.testing.assert_allclose(got_out, want_out, rtol=0,
                               atol=TOL["bfloat16"])
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-6,
                               atol=TOL["bfloat16"])
    rng = np.random.default_rng(dh + q_off)
    dout = rng.normal(0, 1, q.shape).astype(np.float32)
    dlse = rng.normal(0, 1, (1, 2, tq)).astype(np.float32)
    want = _ref_hop_grads(q, k, v, dout, dlse, causal, q_off, k_off,
                          "bfloat16")
    tq_, tk_, tv_, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                          for a in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq_, tk_, tv_, causal, q_off, k_off)
    got = fa.flash_attention_bwd_plain(tq_, tk_, tv_, out, lse, tdo,
                                       torch.from_numpy(dlse), causal,
                                       q_off, k_off)
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=0,
            atol=BWD_TOL["bfloat16"] * np.abs(w).max(), err_msg=f"d{name}")


def _column_chunks(q, k, v, dout, lse, delta, causal, q_off, k_off,
                   chunk):
    """out, dq, dk and dv computed as the kernels compute them past 128:
    one output column chunk at a time, each from the scores over the
    whole head dim (f32, head-major (B, H, T, ·))."""
    qh, kh, doh, p, ds = fa._recompute(q, k, v, dout, lse, delta, causal,
                                       q_off, k_off)
    vh = v.permute(0, 2, 1, 3).float()
    parts = {"out": [], "dq": [], "dk": [], "dv": []}
    for c in range(0, q.shape[3], chunk):
        cols = slice(c, c + chunk)
        parts["out"].append(p @ vh[..., cols])
        parts["dq"].append(ds @ kh[..., cols])
        parts["dk"].append(ds.transpose(-1, -2) @ qh[..., cols])
        parts["dv"].append(p.transpose(-1, -2) @ doh[..., cols])
    return {key: torch.cat(val, dim=-1) for key, val in parts.items()}


@pytest.mark.parametrize("causal,q_off,k_off", [(False, 0, 0),
                                                (True, 8, 24)])
def test_column_chunks_make_the_whole(causal, q_off, k_off):
    """The algebra of the kernels' column split: out[:, c] = p·v[:, c],
    dq[:, c] = ds·k[:, c], dk[:, c] = dsᵀ·q[:, c] and
    dv[:, c] = pᵀ·do[:, c], with p and ds from the full head dim, so the
    chunks of 128 (the last one ragged here) put together equal the
    products over all columns."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 32, 24, 2, 200, seed=9))
    dout = torch.from_numpy(np.random.default_rng(10).normal(
        0, 1, q.shape).astype(np.float32))
    _, lse = fa.flash_attention_plain(q, k, v, causal, q_off, k_off)
    delta = torch.from_numpy(np.random.default_rng(11).normal(
        0, 1, lse.shape).astype(np.float32))
    chunked = _column_chunks(q, k, v, dout, lse, delta, causal, q_off,
                             k_off, chunk=128)
    whole = _column_chunks(q, k, v, dout, lse, delta, causal, q_off,
                           k_off, chunk=q.shape[3])
    rows = {"out": 32, "dq": 32, "dk": 24, "dv": 24}
    for key in whole:
        assert chunked[key].shape == whole[key].shape == (2, 2, rows[key],
                                                          200)
        torch.testing.assert_close(chunked[key], whole[key], rtol=0,
                                   atol=1e-5, msg=key)
    # and the whole is the plain versions' function
    out, _ = fa.flash_attention_plain(q, k, v, causal, q_off, k_off)
    dq = fa.flash_attention_dq_plain(q, k, v, dout, lse, delta, causal,
                                     q_off, k_off)
    dk, dv = fa.flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal,
                                          q_off, k_off)
    for key, plain in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        torch.testing.assert_close(whole[key].permute(0, 2, 1, 3), plain,
                                   rtol=0, atol=1e-5, msg=key)


def _bwd_meta_args(bad_at: int, bad: torch.Tensor):
    """bf16 meta (q, k, v, dout, lse, delta) with ``bad`` in place of
    operand ``bad_at``."""
    ops = [_meta(1, 8, 2, 64) for _ in range(4)]
    ops[bad_at] = bad
    stat = torch.zeros(1, 2, 8, device="meta")
    return (*ops, stat, stat)


@pytest.mark.parametrize("make,problem", [
    (lambda: _meta(1, 8, 2, 64, 2)[..., 0], "the head dim is not contiguous"),
    (lambda: _meta(1, 8, 2, 72)[..., 1:65], "the base address"),
    (lambda: _meta(1, 8, 2, 68)[..., :64], "byte strides"),
])
@pytest.mark.parametrize("fn", ["dq", "dkv"])
def test_backward_checks_tma_preconditions_before_the_device(make, problem,
                                                             fn):
    """The bf16 dq and dk/dv kernels read q, k, v and dout through TMA
    tensor maps: a layout TMA cannot describe raises, naming the
    precondition, before any device work; the legal layout reaches the
    device check."""
    wrapper = getattr(fa, f"flash_attention_{fn}")
    for i, name in enumerate(("q", "k", "v", "dout")):
        with pytest.raises(ValueError, match=f"{name}: TMA cannot read "
                                             f"this operand: {problem}"):
            wrapper(*_bwd_meta_args(i, make()))
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(*_bwd_meta_args(0, _meta(1, 8, 2, 64)))


def test_kernel_build_hashes_the_shared_header(tmp_path, monkeypatch):
    """The build directory's name hashes the sources and the headers
    they include (``csrc/*.cuh``): an edited header must not load a
    library built from the old one."""
    from znicz_tpu_torch.ops import _cuda
    for path in _cuda.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    assert "hopper.cuh" in _cuda.headers()
    before = _cuda.build_dir()
    assert _cuda.build_dir() == before
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _cuda.build_dir() != before


def _f32_kernel_order(q, k, v, causal, q_off, k_off):
    """The f32 forward kernel's order of work (``csrc/flash_attention_f32.cu``)
    in torch, f32, on (B, T, H, dh) numpy operands: the head dim
    zero-padded to the kernel's width, the output in column chunks of
    the widest power of two up to 256 that divides it, each chunk
    walking 64-key tiles (causal: only those a row can see) with a
    base-2 online softmax: log2 e folded into the scale, the running sum
    and output rescaled by ``exp2(m − m_new)`` each tile, ``lse`` turned
    back to the natural log, exactly -1e30 where no key was visible.
    Returns (out (B, Tq, H, dh), lse (B, H, Tq))."""
    tq, dh = q.shape[1], q.shape[3]
    width = fa.kernel_head_dim(dh)
    qh, kh, vh = (F.pad(torch.from_numpy(a), (0, width - dh))
                  .permute(0, 2, 1, 3) for a in (q, k, v))
    tk = kh.shape[2]
    scale_log2 = math.log2(math.e) / math.sqrt(dh)
    chunk = 256
    while width % chunk:
        chunk //= 2
    rows = q_off + torch.arange(tq)[:, None]
    tiles = range(0, tk, 64)
    if causal:
        tiles = [k0 for k0 in tiles if k_off + k0 <= q_off + tq - 1]
    outs = []
    for c0 in range(0, width, chunk):
        m = torch.full(qh.shape[:3], fa.NEG_INF)
        l = torch.zeros(qh.shape[:3])
        acc = torch.zeros(*qh.shape[:3], chunk)
        for k0 in tiles:
            kt, vt = kh[:, :, k0:k0 + 64], vh[:, :, k0:k0 + 64, c0:c0 + chunk]
            visible = torch.ones(tq, kt.shape[2], dtype=torch.bool)
            if causal:
                visible = rows >= k_off + k0 + torch.arange(kt.shape[2])
            s = torch.where(visible, (qh @ kt.transpose(-1, -2)) * scale_log2,
                            torch.tensor(fa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.where(visible, torch.exp2(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append(acc / l[..., None])
    lse = torch.where(m == fa.NEG_INF, torch.tensor(fa.NEG_INF),
                      (m + torch.log2(l)) * math.log(2.0))
    out = torch.cat(outs, dim=-1)[..., :dh].permute(0, 2, 1, 3)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("dh", [40, 264])
@pytest.mark.parametrize("causal,q_off,k_off,tq,tk", [
    (False, 0, 0, 32, 80),        # a ragged second key tile
    (True, 0, 0, 48, 80),         # the diagonal through both key tiles
    (True, 32, 0, 32, 80),        # cross lengths, the diagonal mid-keys
    (True, 8, 24, 32, 48),        # rows 8..23 see no key: fully masked
])
def test_f32_kernel_order_matches_reference_kernel(dh, causal, q_off, k_off,
                                                   tq, tk):
    """The f32 forward kernel's order of work, emulated in torch on the
    CPU, against the reference's Pallas ``_fwd_kernel`` in interpret
    mode: 64-key tiles and a base-2 online softmax here, 16-key blocks
    and a natural-base one there, so the two differ in summation order
    and in the rounding of exp and log only (the file's f32 ``TOL``).
    dh 40 runs at width 64 in one chunk, dh 264 at width 384 in chunks
    of 128.  Fully masked rows give out 0 and lse exactly -1e30, as the
    plain version does."""
    q, k, v = _qkv(2, tq, tk, 2, dh, seed=dh + tq + tk + q_off)
    want_out, want_lse = _ref_hop(q, k, v, causal, q_off, k_off, "float32",
                                  block=16)
    got_out, got_lse = _f32_kernel_order(q, k, v, causal, q_off, k_off)
    np.testing.assert_allclose(got_out, want_out, rtol=0,
                               atol=TOL["float32"])
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-6,
                               atol=TOL["float32"])
    _, plain_lse = _port_plain(q, k, v, causal, q_off, k_off, "float32")
    masked = q_off + np.arange(tq) < k_off if causal else np.zeros(tq, bool)
    np.testing.assert_array_equal(plain_lse == fa.NEG_INF,
                                  np.broadcast_to(masked, plain_lse.shape))
    assert np.all(got_lse[:, :, masked] == np.float32(fa.NEG_INF))
    assert np.all(got_lse[:, :, masked] == plain_lse[:, :, masked])
    assert np.all(got_out[:, masked] == 0.0)


def test_f32_kernels_share_one_header():
    """Both f32 sources build on ``csrc/simt_f32.cuh`` (hashed into the
    build directory with the other headers), and neither keeps a copy
    of what it holds: the swizzle, the 128-bit load, the register-tiled
    score product, the ``cp.async`` ring's pieces and ``ex2``."""
    from znicz_tpu_torch.ops import _cuda
    assert "simt_f32.cuh" in _cuda.headers()
    def defines(text, name):
        return re.search(rf"\b(?:void|int|float4?|bool)\s+{name}\s*\(",
                         text) is not None

    header = (_cuda.CSRC / "simt_f32.cuh").read_text()
    helpers = ("swz", "ld4", "slice_dots", "cp_async16", "cp_async_commit",
               "cp_async_wait", "exp2_ftz", "stage", "chunk_width")
    for name in helpers:
        assert defines(header, name), name
    for source in ("flash_attention_f32.cu", "flash_attention_bwd_f32.cu"):
        text = (_cuda.CSRC / source).read_text()
        assert '#include "simt_f32.cuh"' in text, source
        for name in helpers:
            assert not defines(text, name), (source, name)
