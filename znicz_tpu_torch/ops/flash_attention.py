"""Flash-attention forward (port of ``znicz_tpu/ops/pallas_attention.py``).

:func:`flash_attention_fwd` is the wrapper of the CUDA kernel
``csrc/flash_attention_fwd.cu``, which replaces the Pallas TPU kernel
``_fwd_kernel`` (B7).  It returns ``(out, lse)`` as the reference's
``_flash_hop`` does: ``out`` in q's dtype, ``lse`` the f32 row
logsumexp, with ``q_offset``/``k_offset`` placing the call on a global
sequence axis for causal masking (the ring-hop geometry a later slice
builds on).  :func:`flash_attention` is the public entry the attention
unit calls: it casts the operands to ``dot_dtype`` first and upcasts
``out`` to f32, as the reference's ``flash_attention`` does.

Layout: the boundary layout (B, T, H, dh) throughout.  The kernel
reads it through strides, so the reference's head-major transposes
(``pack_heads``) have no counterpart here; ``head_pack`` existed to
fill the TPU's 128-lane tiles and is not carried over.

:func:`flash_attention_plain` computes the same function with plain
PyTorch.  The wrapper uses it only for tensors on the CPU; a CUDA
tensor gets the kernel or an error.  Forward only: the backward
kernels (B8/B9) arrive with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from znicz_tpu_torch import backends  # noqa: F401 — no TF32 in f32 products
from znicz_tpu_torch.ops import _cuda

NEG_INF = -1e30
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)

_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = _cuda.library("flash_attention_fwd")
    if not _argtypes_set:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.znicz_flash_attention_fwd.argtypes = (
            [p] * 5 + [i] * 5 + [ll] * 12
            + [ctypes.c_float, i, ll, ll, p])
        lib.znicz_flash_attention_fwd.restype = i
        _argtypes_set = True
    return lib


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


def _check_kernel_operand(name: str, a: torch.Tensor) -> None:
    """The kernel reads 16-byte chunks of each (b, t, h) row."""
    if a.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, "
                         f"strides {a.stride()}")
    if a.data_ptr() % 16 or any(s % 8 for s in a.stride()[:3]):
        raise ValueError(f"{name}: rows must start on 16-byte "
                         f"boundaries (strides {a.stride()}, "
                         f"offset {a.data_ptr() % 16})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash forward over (B, Tq, H, dh) q and (B, Tk, H, dh) k/v:
    ``(out (B, Tq, H, dh) in q's dtype, lse (B, H, Tq) f32)``.

    On the card: bf16 operands, dh in :data:`KERNEL_HEAD_DIMS`, any
    Tq/Tk (the ragged tile is masked).  CPU tensors take
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset, k_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the flash kernel takes bfloat16 operands, got "
                         f"{q.dtype}")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, a)
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().znicz_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, tq, tk, dh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / math.sqrt(dh), int(bool(causal)), int(q_offset),
            int(k_offset), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed "
                           f"(cudaError {err})")
    flash_attention_fwd.launches += 1
    return out, lse


#: kernel launches since the counter was last set to 0
flash_attention_fwd.launches = 0


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, dot_dtype: torch.dtype | None = None,
                    q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """Fused attention (B, T, H, dh) → (B, T, H, dh) f32: operands cast
    to ``dot_dtype`` (the tile-product dtype, bf16 in mixed precision),
    the kernel's ``out`` upcast to f32 — the reference's public
    ``flash_attention``."""
    if dot_dtype is not None:
        q, k, v = (a.to(dot_dtype) for a in (q, k, v))
    out, _ = flash_attention_fwd(q, k, v, causal, q_offset, k_offset)
    return out.float()
