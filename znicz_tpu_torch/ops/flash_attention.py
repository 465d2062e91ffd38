"""Flash attention (port of ``znicz_tpu/ops/pallas_attention.py``).

Three CUDA kernels, each replacing one Pallas TPU kernel, each with a
launch counter and a plain PyTorch version beside it:

- :func:`flash_attention_fwd` (``csrc/flash_attention_fwd.cu``,
  replacing ``_fwd_kernel``, B7) returns ``(out, lse)`` as the
  reference's ``_flash_hop`` does: ``out`` in q's dtype, ``lse`` the f32
  row logsumexp;
- :func:`flash_attention_dq` and :func:`flash_attention_dkv`
  (``csrc/flash_attention_bwd.cu``, and ``csrc/flash_attention_bwd_f32.cu``
  for f32 operands, replacing ``_dq_kernel`` and ``_dkv_kernel``, B8 and
  B9) recompute ``p = exp(s − lse)`` tile by tile and return dq, and dk
  and dv.

``q_offset``/``k_offset`` place a call on a global sequence axis for
causal masking (the ring-hop geometry a later slice builds on).
:func:`flash_attention_bwd` is the backward of one such call: it forms
``delta = rowsum(do·out) − dlse`` in f32 with plain torch ops, as the
reference does in XLA between its kernels, then runs both backward
kernels.  :class:`FlashHop` is the ``torch.autograd.Function`` around
the pair, the counterpart of the reference's ``_flash_hop`` custom_vjp:
its backward folds the lse cotangent into ``delta``, so hops composed
through their lse get the right gradients.  :func:`flash_attention` is
the public entry the attention unit calls: it casts the operands to
``dot_dtype`` first and upcasts ``out`` to f32, as the reference's
``flash_attention`` does, and it is differentiable through
:class:`FlashHop`.

Layout: the boundary layout (B, T, H, dh) throughout.  The kernels read
and write it through strides, so the reference's head-major transposes
(``pack_heads``) have no counterpart here; ``head_pack`` existed to
fill the TPU's 128-lane tiles and is not carried over.

Operand dtypes and head dims on the card: bf16 operands go to the
tensor-core kernels (``flash_attention_fwd.cu``, ``flash_attention_bwd.cu``,
TMA + wgmma), f32 operands to the f32 SIMT kernels
(``flash_attention_f32.cu`` forward, ``flash_attention_bwd_f32.cu``
backward), as the reference's kernels take both.
Every multiple of 8 runs on them, as the reference's kernel takes it.
The bf16 kernels read their operands through TMA tensor maps that carry
the true dh and zero-fill the columns past it (zero columns change no
score), so they need no padded copy; their wrappers check TMA's
preconditions (:func:`_check_tma_operand`) before the device.  The f32
kernels take head dims :data:`KERNEL_HEAD_DIMS`, and any other
multiple of 8 up to 256 is zero-padded to the next one (the padded
columns of the results are sliced off, and the scale stays ``1/√dh``
of the true dh).  Past 256 (:data:`STREAMED_PAST`) the bf16 forward
takes a streamed variant that passes the score operands through
shared memory in 64-column slices, so shared memory does not grow
with dh; the bf16 backward streams past 128 by design.  The f32
kernels, forward and backward, stream every width in 32-column slices
through a ``cp.async`` ring and split the output into column chunks
past 256 (the forward, dq) or 128 (dk/dv); past 256 they take the
head dim zero-padded to a multiple of :data:`STREAMED_CHUNK`
(:func:`kernel_head_dim`).  They copy an operand whose rows do not
start on 16-byte boundaries (:func:`_rows_aligned`), as their loads
are 16 bytes wide.  Whether a call goes to the kernels at all
is :func:`kernel_legal`, the reference's rule: a head dim that is not
a multiple of 8 takes :func:`local_attention`, the reference's XLA
core, on every device.  Each wrapper counts its launches in
``launches`` and, by kernel, in ``launches_by_variant``
(:data:`VARIANTS`: ``"bf16"`` and ``"f32"``, ``"dh32"``, ``"dh256"``
and ``"wide"`` for bf16 calls of head dims up to 32, from 129 to 256
and past 256, and ``"f32_dh256"`` and ``"f32_wide"`` alike).

A wrapper uses its plain version only for tensors on the CPU; a CUDA
tensor gets the kernel or an error.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from znicz_tpu_torch import backends  # noqa: F401 — no TF32 in f32 products
from znicz_tpu_torch.ops import _cuda, launch_counts

NEG_INF = -1e30
#: head dims the f32 kernels take up to 256
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: head dims past this one take the bf16 forward's streamed variant
STREAMED_PAST = KERNEL_HEAD_DIMS[-1]
#: past :data:`STREAMED_PAST`, the f32 kernels' head dim is padded to a
#: multiple of it
STREAMED_CHUNK = 128
#: the kernels' launch counters by variant: operand dtype and width
VARIANTS = ("bf16", "f32", "dh32", "dh256", "f32_dh256", "wide",
            "f32_wide")

#: operand dtype → (library stem of the forward, of the backward, suffix
#: of the C entry points)
_LIBS = {torch.bfloat16: ("flash_attention_fwd", "flash_attention_bwd", ""),
         torch.float32: ("flash_attention_f32", "flash_attention_bwd_f32",
                         "_f32")}

_bound: set[str] = set()


def _fn(dtype: torch.dtype, which: str):
    """The C entry point ``znicz_flash_attention_<which>`` for operands
    of ``dtype``, its signature declared (pointers and the stream as
    ``c_void_p``, so ctypes never cuts a 64-bit address)."""
    fwd_stem, bwd_stem, suffix = _LIBS[dtype]
    lib = _cuda.library(fwd_stem if which == "fwd" else bwd_stem)
    name = f"znicz_flash_attention_{which}{suffix}"
    fn = getattr(lib, name)
    if name not in _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [ctypes.c_float, i, ll, ll, p]
        fn.argtypes = {"fwd": [p] * 5 + [i] * 5 + [ll] * 12 + tail,
                       "dq": [p] * 7 + [i] * 5 + [p] + [ll] * 3 + tail,
                       "dkv": [p] * 8 + [i] * 5 + [p, p] + tail}[which]
        fn.restype = i
        _bound.add(name)
    return fn


def kernel_legal(dh: int) -> bool:
    """The reference's rule for engaging its kernel
    (``pallas_attention.kernel_legal``, copied): the head dim must be a
    multiple of 8.  Its other terms, T divisible by the TPU's blocks,
    are tiling limits that the port's kernels do not have: they mask
    the ragged tile.  Otherwise the attention unit takes
    :func:`local_attention`, the reference's XLA core."""
    return dh % 8 == 0


def kernel_head_dim(dh: int) -> int:
    """The width an f32 kernel call of head dim ``dh`` runs at, ``dh``
    zero-padded: the next of :data:`KERNEL_HEAD_DIMS` up to 256, past
    that the next multiple of :data:`STREAMED_CHUNK`.  It also names
    the launch counters' variant of a bf16 call, whose kernels read the
    true dh.  Any multiple of 8 is taken."""
    if not kernel_legal(dh) or dh <= 0:
        raise ValueError(f"the flash kernels take head dims that are "
                         f"multiples of 8, got {dh}")
    if dh > STREAMED_PAST:
        return -(-dh // STREAMED_CHUNK) * STREAMED_CHUNK
    return next(w for w in KERNEL_HEAD_DIMS if w >= dh)


def _count(fn, dtype: torch.dtype, width: int) -> None:
    """One launch of ``fn``'s kernel for ``dtype`` operands of the
    width ``width`` (:func:`kernel_head_dim`)."""
    variant = "wide" if width > STREAMED_PAST else \
        {32: "dh32", 256: "dh256"}.get(width, "bf16")
    if dtype == torch.float32:
        variant = {"wide": "f32_wide", "dh256": "f32_dh256"}.get(variant,
                                                                 "f32")
    fn.launches += 1
    fn.launches_by_variant[variant] += 1


def _padded(a: torch.Tensor, width: int) -> torch.Tensor:
    """``a`` (…, dh) zero-padded to ``width`` columns (``a`` itself when
    it is that wide)."""
    dh = a.shape[-1]
    return a if dh == width else F.pad(a, (0, width - dh))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, T, H, dh) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, dh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on (B, H, dh)")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"operand dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def _kernel_layout_ok(a: torch.Tensor) -> bool:
    """The head dim contiguous; for bf16, whose kernels read through
    TMA, the base and every (b, t, h) stride on 16-byte boundaries too
    (:func:`_check_tma_operand` checks the rest of TMA's rules)."""
    if a.stride(-1) != 1:
        return False
    return a.dtype != torch.bfloat16 or (
        a.data_ptr() % 16 == 0 and not any(s % 8 for s in a.stride()[:3]))


def _rows_aligned(a: torch.Tensor) -> torch.Tensor:
    """``a``, or a contiguous copy where its base or a (b, t, h) stride
    is off a 16-byte boundary: the f32 kernels copy their operands in
    16-byte pieces."""
    es = a.element_size()
    if a.data_ptr() % 16 == 0 and not any(s * es % 16
                                          for s in a.stride()[:3]):
        return a
    return a.contiguous()


def _check_kernel_operand(name: str, a: torch.Tensor) -> None:
    if not _kernel_layout_ok(a):
        raise ValueError(f"{name}: the head dim must be contiguous and "
                         f"bf16 rows must start on 16-byte boundaries "
                         f"(strides {a.stride()}, offset "
                         f"{a.data_ptr() % 16})")


#: TMA's limits on a tensor map's strides (bytes) and sizes
_TMA_MAX_STRIDE = 2 ** 40
_TMA_MAX_SIZE = 2 ** 32


def _check_tma_operand(name: str, a: torch.Tensor) -> None:
    """TMA's preconditions on a (B, T, H, dh) bf16 operand of the bf16
    kernels, which describe it as the tensor (dh, H, T, B): the head dim
    contiguous, the base address and every other stride on a 16-byte
    boundary, strides under 2⁴⁰ bytes and sizes under 2³².  (The boxes
    they load are 64 columns by at most 128 rows, inside TMA's 256 a
    dim.)  Raises before the device is touched."""
    es = a.element_size()
    strides = [s * es for s in a.stride()[:3]]
    problem = None
    if a.stride(-1) != 1:
        problem = f"the head dim is not contiguous (strides {a.stride()})"
    elif a.data_ptr() % 16:
        problem = (f"the base address is {a.data_ptr() % 16} bytes past a "
                   f"16-byte boundary")
    elif any(s % 16 for s in strides):
        problem = f"byte strides {strides} are not multiples of 16"
    elif any(s >= _TMA_MAX_STRIDE for s in strides) or \
            any(n >= _TMA_MAX_SIZE for n in a.shape):
        problem = f"shape {tuple(a.shape)} or strides exceed TMA's limits"
    if problem:
        raise ValueError(f"{name}: TMA cannot read this operand: {problem}")


def _check_kernel_call(q: torch.Tensor, name: str) -> int:
    """What every kernel takes: bf16 or f32 operands and a head dim that
    is a multiple of 8.  Returns :func:`kernel_head_dim`."""
    if q.dtype not in _LIBS:
        raise ValueError(f"the {name} kernel takes {list(_LIBS)} "
                         f"operands, got {q.dtype}")
    return kernel_head_dim(q.shape[3])


def _check_device(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")


def _check_launch(name: str, err: int) -> None:
    """Raises for a C entry point's return: a negative CUresult of
    ``cuTensorMapEncodeTiled``, or a launch's cudaError."""
    if err < 0:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (CUresult {-err - 1})")
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError "
                           f"{err})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash forward over (B, Tq, H, dh) q and (B, Tk, H, dh) k/v:
    ``(out (B, Tq, H, dh) in q's dtype, lse (B, H, Tq) f32)``.

    On the card: bf16 or f32 operands, dh a multiple of 8, any Tq/Tk
    (the ragged tile is masked).  bf16 operands go through TMA,
    whose preconditions are checked first.  CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset, k_offset)
    width = _check_kernel_call(q, "flash")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    if q.dtype == torch.bfloat16:
        for name, a in (("q", q), ("k", k), ("v", v)):
            _check_tma_operand(name, a)
        _check_device(q)
        cols = dh  # TMA zero-fills the columns past dh
    else:
        _check_device(q)
        q, k, v = (_rows_aligned(_padded(a, width)) for a in (q, k, v))
        for name, a in (("q", q), ("k", k), ("v", v)):
            _check_kernel_operand(name, a)
        cols = width
    out = torch.empty((b, tq, h, cols), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(q.dtype, "fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, cols,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            scale, int(bool(causal)), int(q_offset), int(k_offset), stream)
    _check_launch("flash_attention_fwd", err)
    _count(flash_attention_fwd, q.dtype, width)
    return out[..., :dh], lse


#: kernel launches since the counter was last set to 0, in all and by
#: kernel
flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, q_offset: int = 0,
                          k_offset: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the whole score matrix
    at once, with the reference kernel's numerics (scale after the
    product, masked logits -1e30 and masked p 0, f32 statistics, p
    rounded to the operand dtype before the p·v product, l floored at
    1e-30, out stored in q's dtype)."""
    _check(q, k, v)
    tq, dh = q.shape[1], q.shape[3]
    tk = k.shape[1]
    qh, kh, vh = (a.permute(0, 2, 1, 3).float() for a in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    mask = None
    if causal:
        rows = q_offset + torch.arange(tq, device=q.device)
        cols = k_offset + torch.arange(tk, device=q.device)
        mask = rows[:, None] >= cols[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), vh)
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return out, (m + torch.log(l)).squeeze(-1)


def _check_bwd(q, k, v, dout, lse, delta) -> None:
    _check(q, k, v)
    b, tq, h, _ = q.shape
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be f32 of shape {(b, h, tq)} "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _bwd_args(q, k, v, dout, lse, delta, name):
    """The checks and the shared leading arguments of both backward
    kernels' C calls: ``(width, scale, operands, pointers, geometry,
    input strides)``.  bf16 operands are read through TMA at the true
    head dim (their preconditions checked first); f32 operands are
    zero-padded to ``width`` (:func:`kernel_head_dim`), rows on 16-byte
    boundaries (:func:`_rows_aligned`).  The scale is that of the true
    head dim."""
    width = _check_kernel_call(q, name)
    if dout.dtype != q.dtype:
        raise ValueError(f"dout must be {q.dtype}, got {dout.dtype}")
    names = ("q", "k", "v", "dout")
    if q.dtype == torch.bfloat16:
        for arg, a in zip(names, (q, k, v, dout)):
            _check_tma_operand(arg, a)
        _check_device(q)
        ops, cols = [q, k, v, dout], q.shape[3]
    else:
        _check_device(q)
        ops = [_rows_aligned(_padded(a, width)) for a in (q, k, v, dout)]
        cols = width
        for arg, a in zip(names, ops):
            _check_kernel_operand(arg, a)
    scale = 1.0 / math.sqrt(q.shape[3])
    for arg, t in (("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    b, tq, h, _ = q.shape
    strides = (ctypes.c_longlong * 12)(
        *(s for a in ops for s in a.stride()[:3]))
    return (width, scale, ops,
            [*(a.data_ptr() for a in ops), lse.data_ptr(),
             delta.data_ptr()],
            [b, h, tq, k.shape[1], cols], strides)


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, causal: bool = False,
                       q_offset: int = 0, k_offset: int = 0
                       ) -> torch.Tensor:
    """dq (B, Tq, H, dh) in q's dtype from the forward's ``lse`` and
    ``delta = rowsum(do·out) − dlse`` (both (B, H, Tq) f32).  On the
    card: bf16 or f32, dh a multiple of 8, any Tq/Tk; bf16 operands go
    through TMA, whose preconditions are checked first.  CPU tensors
    take :func:`flash_attention_dq_plain`."""
    _check_bwd(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, dout, lse, delta, causal,
                                        q_offset, k_offset)
    width, scale, ops, ptrs, geom, strides = _bwd_args(
        q, k, v, dout, lse, delta, "flash dq")
    out = torch.empty(ops[0].shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(q.dtype, "dq")(
            *ptrs, out.data_ptr(), *geom, strides, *out.stride()[:3],
            scale, int(bool(causal)), int(q_offset), int(k_offset), stream)
    _check_launch("flash_attention_dq", err)
    _count(flash_attention_dq, q.dtype, width)
    return out[..., :q.shape[3]]


#: kernel launches since the counter was last set to 0, in all and by
#: kernel
flash_attention_dq.launches = 0
flash_attention_dq.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = False,
                        q_offset: int = 0, k_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``, each (B, Tk, H, dh) in k's and v's dtype, from the
    same inputs as :func:`flash_attention_dq`.  CPU tensors take
    :func:`flash_attention_dkv_plain`."""
    _check_bwd(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal,
                                         q_offset, k_offset)
    width, scale, ops, ptrs, geom, strides = _bwd_args(
        q, k, v, dout, lse, delta, "flash dk/dv")
    dk = torch.empty(ops[1].shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(ops[2].shape, dtype=v.dtype, device=v.device)
    out_strides = (ctypes.c_longlong * 6)(*dk.stride()[:3],
                                          *dv.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(q.dtype, "dkv")(
            *ptrs, dk.data_ptr(), dv.data_ptr(), *geom, strides,
            out_strides, scale, int(bool(causal)), int(q_offset),
            int(k_offset), stream)
    _check_launch("flash_attention_dkv", err)
    _count(flash_attention_dkv, q.dtype, width)
    dh = q.shape[3]
    return dk[..., :dh], dv[..., :dh]


#: kernel launches since the counter was last set to 0, in all and by
#: kernel
flash_attention_dkv.launches = 0
flash_attention_dkv.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def _recompute(q, k, v, dout, lse, delta, causal, q_offset, k_offset):
    """The backward kernels' shared recompute in plain PyTorch, head-
    major f32: ``(q, k, do, p, ds)`` with ``p = exp(s − lse)`` (masked
    logits −1e30 and masked p 0, as the reference's ``_p_tile``) and
    ``ds = p·(dp − delta)·scale``."""
    tq, dh = q.shape[1], q.shape[3]
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qh, kh, vh, doh = (a.permute(0, 2, 1, 3).float()
                       for a in (q, k, v, dout))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    mask = None
    if causal:
        rows = q_offset + torch.arange(tq, device=q.device)
        cols = k_offset + torch.arange(tk, device=q.device)
        mask = rows[:, None] >= cols[None, :]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse.float()[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None]) * scale
    return qh, kh, doh, p, ds


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 values rounded to ``dtype`` (the operand dtype of the next
    tile product), kept in f32."""
    return t.to(dtype).float()


def _boundary(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Head-major f32 (B, H, T, dh) → boundary layout in ``dtype``."""
    return t.to(dtype).permute(0, 2, 1, 3).contiguous()


def flash_attention_dq_plain(q, k, v, dout, lse, delta, causal=False,
                             q_offset=0, k_offset=0) -> torch.Tensor:
    """dq in plain PyTorch with the reference kernel's numerics: ds
    rounded to the operand dtype before ``ds·k``, f32 accumulation,
    stored in q's dtype."""
    _check_bwd(q, k, v, dout, lse, delta)
    _, kh, _, _, ds = _recompute(q, k, v, dout, lse, delta, causal,
                                 q_offset, k_offset)
    return _boundary(torch.matmul(_rounded(ds, k.dtype), kh), q.dtype)


def flash_attention_dkv_plain(q, k, v, dout, lse, delta, causal=False,
                              q_offset=0, k_offset=0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` in plain PyTorch: p and ds rounded to the operand
    dtype before ``pᵀ·do`` and ``dsᵀ·q``, f32 accumulation."""
    _check_bwd(q, k, v, dout, lse, delta)
    qh, _, doh, p, ds = _recompute(q, k, v, dout, lse, delta, causal,
                                   q_offset, k_offset)
    dv = torch.matmul(_rounded(p, dout.dtype).transpose(-1, -2), doh)
    dk = torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2), qh)
    return _boundary(dk, k.dtype), _boundary(dv, v.dtype)


def _bwd(q, k, v, out, lse, dout, dlse, causal, q_offset, k_offset,
         dq_fn, dkv_fn):
    dout = dout.to(q.dtype)
    delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    delta = delta.contiguous()
    args = (q, k, v, dout, lse, delta, causal, q_offset, k_offset)
    return (dq_fn(*args), *dkv_fn(*args))


def flash_attention_bwd(q, k, v, out, lse, dout, dlse=None,
                        causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0):
    """The backward of one flash call: ``(dq, dk, dv)`` from the
    forward's saved ``(q, k, v, out, lse)`` and the cotangents of
    ``out`` and ``lse`` (``dlse`` None for a call whose lse was not
    used).  As the reference's ``_hop_bwd``: ``do`` is cast to q's
    dtype, ``delta = rowsum(do·out) − dlse`` is formed in f32 by plain
    torch ops, then the dq and dk/dv kernels run."""
    return _bwd(q, k, v, out, lse, dout, dlse, causal, q_offset, k_offset,
                flash_attention_dq, flash_attention_dkv)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, dlse=None,
                              causal: bool = False, q_offset: int = 0,
                              k_offset: int = 0):
    """:func:`flash_attention_bwd` through the kernels' plain versions,
    on any device."""
    return _bwd(q, k, v, out, lse, dout, dlse, causal, q_offset, k_offset,
                flash_attention_dq_plain, flash_attention_dkv_plain)


class FlashHop(torch.autograd.Function):
    """One flash call at global offsets, differentiable in q, k and v:
    ``(out, lse)`` forward through the flash kernel, the dq and dk/dv
    kernels backward — the counterpart of the reference's
    ``_flash_hop`` custom_vjp.  The lse cotangent enters ``delta``, so
    a composition of hops through their lse (the ring) differentiates
    correctly."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        out, lse = flash_attention_fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.geometry = (bool(causal), int(q_offset), int(k_offset))
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        # one layout rule, not a fallback: autograd may hand over a dout
        # the kernels cannot read (for bf16, TMA's 16-byte base and
        # strides); such a dout is copied to a contiguous one
        if dout.device.type == "cuda" and not _kernel_layout_ok(dout):
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, dlse,
                                         *ctx.geometry)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, dot_dtype: torch.dtype | None = None,
                    q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """Fused attention (B, T, H, dh) → (B, T, H, dh) f32: operands cast
    to ``dot_dtype`` (the tile-product dtype, bf16 in mixed precision),
    the kernel's ``out`` upcast to f32 — the reference's public
    ``flash_attention``.  Differentiable through :class:`FlashHop`."""
    if dot_dtype is not None:
        q, k, v = (a.to(dot_dtype) for a in (q, k, v))
    out, _ = FlashHop.apply(q, k, v, causal, q_offset, k_offset)
    return out.float()


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    dot_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Softmax attention over the whole score matrix in plain PyTorch,
    differentiable by autograd: the reference's XLA core
    (``ring_attention.local_attention``), which the attention unit takes
    where :func:`kernel_legal` does not hold.  (B, Tq, H, dh) q and
    (B, Tk, H, dh) k/v → (B, Tq, H, dh) f32.  With ``dot_dtype`` the
    operands and the (T, T) scores and probabilities are stored in it,
    the softmax statistics are f32, and the products accumulate in f32;
    without it everything is f32."""
    dh = q.shape[-1]
    if dot_dtype is not None:
        q, k, v = (a.to(dot_dtype) for a in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    if dot_dtype is not None:
        s = s.to(dot_dtype)
        m = s.amax(dim=-1, keepdim=True).float().detach()
        e = torch.exp(s.float() - m)
        p = (e / e.sum(dim=-1, keepdim=True)).to(dot_dtype)
    else:
        p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   dot_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The attention unit's core, routed as the reference routes it: the
    flash kernels (:func:`flash_attention`) where :func:`kernel_legal`
    holds for the head dim, else :func:`local_attention`."""
    if kernel_legal(q.shape[-1]):
        return flash_attention(q, k, v, causal=causal, dot_dtype=dot_dtype)
    return local_attention(q, k, v, causal=causal, dot_dtype=dot_dtype)


launch_counts.register(flash_attention_fwd, flash_attention_dq,
                       flash_attention_dkv)
