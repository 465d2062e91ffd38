"""Fused row kernels (port of ``znicz_tpu/ops/pallas_kernels.py``).

The layer norm, both directions:

- :func:`layer_norm_forward` wraps the CUDA kernel
  ``csrc/layer_norm_fwd.cu``, which replaces the Pallas TPU kernel
  ``_ln_fwd_kernel`` (B5) — f32 statistics over the last axis,
  ``(x − μ)·rsqrt(var + ε)·γ + β``, output stored in x's dtype, β
  optional;
- :func:`layer_norm_backward` wraps ``csrc/layer_norm_bwd.cu``, which
  replaces ``_ln_bwd_kernel`` (B6) — dx in err's dtype plus the f32
  cross-row γ and β gradient sums, in one pass over the rows.

Each has a plain PyTorch version of the same function beside it
(``*_plain``); a wrapper uses it only for CPU tensors, and a CUDA
tensor gets the kernel or an error.

The reference's other kernels in this module (LRN forward/backward,
dropout, softmax+argmax) belong to a later slice.
"""

from __future__ import annotations

import ctypes

import torch

from znicz_tpu_torch.ops import _cuda

#: x dtypes the kernel takes → its dtype code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_bound: set[str] = set()


def _lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` with its C signatures
    declared (pointers and the stream as ``c_void_p``, so ctypes never
    cuts a 64-bit address)."""
    lib = _cuda.library(stem)
    if stem not in _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if stem == "layer_norm_fwd":
            lib.znicz_layer_norm_fwd.argtypes = [
                p, p, p, p, ll, i, ctypes.c_float, i, i, p]
            lib.znicz_layer_norm_fwd.restype = i
        else:
            lib.znicz_layer_norm_bwd_blocks.argtypes = [ll, i, i]
            lib.znicz_layer_norm_bwd_blocks.restype = ll
            lib.znicz_layer_norm_bwd.argtypes = [
                p, p, p, p, p, p, p, ll, i, ctypes.c_float, i, i, i, p]
            lib.znicz_layer_norm_bwd.restype = i
        _bound.add(stem)
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
        err = _lib("layer_norm_fwd").znicz_layer_norm_fwd(
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


def layer_norm_backward(x: torch.Tensor, err: torch.Tensor,
                        gamma: torch.Tensor, eps: float,
                        with_beta: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor | None]:
    """Layer-norm backward over the last axis: ``(dx, grad_gamma,
    grad_beta or None)`` — dx with x's shape in err's dtype, the sums
    f32 of shape (D,), as the reference's ``layer_norm_backward``
    returns them.  On the card x and err are contiguous f32 or bf16
    (each on its own) and γ is contiguous f32.  The cross-row sums are
    folded in a fixed order, so a rerun gives the same bits."""
    _check(x, gamma, None)
    if err.shape != x.shape or err.device != x.device:
        raise ValueError(f"err {tuple(err.shape)} on {err.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return layer_norm_backward_plain(x, err, gamma, eps, with_beta)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("err", err)):
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"the layer-norm kernel takes "
                             f"{list(_KERNEL_DTYPES)} for {name}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the layer-norm kernel takes a contiguous "
                             f"{name}")
    if gamma.dtype != torch.float32 or not gamma.is_contiguous():
        raise ValueError("gamma must be contiguous float32")
    d = x.shape[-1]
    m = x.numel() // d if d else 0
    lib = _lib("layer_norm_bwd")
    n_blocks = lib.znicz_layer_norm_bwd_blocks(m, d, int(with_beta))
    if n_blocks < 0:
        raise ValueError(f"the layer-norm backward kernel keeps its "
                         f"partial sums in shared memory and takes "
                         f"D up to 51200 (25600 with beta), got {d}")
    dx = torch.empty_like(err)
    grad_g = torch.empty(d, dtype=torch.float32, device=x.device)
    grad_b = (torch.empty(d, dtype=torch.float32, device=x.device)
              if with_beta else None)
    work = torch.empty(max(n_blocks, 1) * d * (2 if with_beta else 1),
                       dtype=torch.float32, device=x.device)
    vec = int(d % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, err, dx, gamma)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.znicz_layer_norm_bwd(
            x.data_ptr(), err.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            grad_g.data_ptr(), None if grad_b is None else grad_b.data_ptr(),
            work.data_ptr(), m, d, float(eps), _KERNEL_DTYPES[x.dtype],
            _KERNEL_DTYPES[err.dtype], vec, stream)
    if code:
        raise RuntimeError(f"layer_norm_backward kernel launch failed "
                           f"(cudaError {code})")
    layer_norm_backward.launches += 1
    return dx, grad_g, grad_b


#: kernel launches since the counter was last set to 0
layer_norm_backward.launches = 0


def layer_norm_backward_plain(x: torch.Tensor, err: torch.Tensor,
                              gamma: torch.Tensor, eps: float,
                              with_beta: bool = True
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor | None]:
    """The backward kernel's function in plain PyTorch, with the
    reference kernel's formulas: f32 statistics, ``dx̂ = err·γ``,
    ``dx = (dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂))·rstd`` stored in err's
    dtype, ``Σ err·x̂`` and ``Σ err`` over rows in f32."""
    _check(x, gamma, None)
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    ef = err.float().reshape(-1, d)
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dxhat = ef * gamma.float()
    dx = (dxhat - dxhat.mean(dim=-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)) * rstd
    grad_g = (ef * xhat).sum(dim=0)
    grad_b = ef.sum(dim=0) if with_beta else None
    return dx.to(err.dtype).reshape(x.shape), grad_g, grad_b
