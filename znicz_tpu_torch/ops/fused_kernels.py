"""Fused row kernels (port of ``znicz_tpu/ops/pallas_kernels.py``).

This slice carries the layer-norm forward: :func:`layer_norm_forward`
wraps the CUDA kernel ``csrc/layer_norm_fwd.cu``, which replaces the
Pallas TPU kernel ``_ln_fwd_kernel`` (B5) — f32 statistics over the
last axis, ``(x − μ)·rsqrt(var + ε)·γ + β``, output stored in x's
dtype, β optional.  :func:`layer_norm_forward_plain` is the same
function in plain PyTorch; the wrapper uses it only for CPU tensors,
and a CUDA tensor gets the kernel or an error.

The reference's other kernels in this module (LRN forward/backward,
dropout, softmax+argmax, layer-norm backward) belong to later slices.
"""

from __future__ import annotations

import ctypes

import torch

from znicz_tpu_torch.ops import _cuda

#: x dtypes the kernel takes → its dtype code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = _cuda.library("layer_norm_fwd")
    if not _argtypes_set:
        p = ctypes.c_void_p
        lib.znicz_layer_norm_fwd.argtypes = [
            p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, p]
        lib.znicz_layer_norm_fwd.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def _check(x: torch.Tensor, gamma: torch.Tensor,
           beta: torch.Tensor | None) -> None:
    d = x.shape[-1]
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is None:
            continue
        if tuple(p.shape) != (d,):
            raise ValueError(f"{name} shape {tuple(p.shape)} != ({d},)")
        if p.device != x.device:
            raise ValueError(f"{name} lies on {p.device}, x on {x.device}")


def layer_norm_forward(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor | None,
                       eps: float) -> torch.Tensor:
    """Layer norm over the last axis of ``x`` (..., D) with f32 γ/β of
    shape (D,); the output has x's shape and dtype.  On the card x is
    contiguous f32 or bf16 and γ/β are contiguous f32."""
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return layer_norm_forward_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the layer-norm kernel takes "
                         f"{list(_KERNEL_DTYPES)}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the layer-norm kernel takes a contiguous x")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is not None and (p.dtype != torch.float32
                              or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32")
    d = x.shape[-1]
    m = x.numel() // d if d else 0
    y = torch.empty_like(x)
    vec = int(d % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, y, gamma, beta)
        if t is not None))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().znicz_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), y.data_ptr(), m, d,
            float(eps), _KERNEL_DTYPES[x.dtype], vec, stream)
    if err:
        raise RuntimeError(f"layer_norm_forward kernel launch failed "
                           f"(cudaError {err})")
    layer_norm_forward.launches += 1
    return y


#: kernel launches since the counter was last set to 0
layer_norm_forward.launches = 0


def layer_norm_forward_plain(x: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor | None,
                             eps: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (f32 statistics, output
    in x's dtype)."""
    _check(x, gamma, beta)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)
