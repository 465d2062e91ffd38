"""Fused row kernels (port of ``znicz_tpu/ops/pallas_kernels.py``).

Each wrapper below launches one CUDA kernel, which replaces one Pallas
TPU kernel of the reference; each has a plain PyTorch version of the
same function beside it (``*_plain``) and an integer ``launches``
counter.  A wrapper uses the plain version only for CPU tensors; a
CUDA tensor gets the kernel or an error.

The cross-channel LRN of AlexNet, over channels-last activations seen
as (rows, C):

- :func:`lrn_forward` wraps ``csrc/lrn.cu``'s forward, which replaces
  ``_lrn_fwd_kernel`` (B1) — ``y = x·(k + α·Σ_win x²)^(−β)``, the
  window ``[c − n//2, c + n − 1 − n//2]``, f32 math, y in x's dtype;
- :func:`lrn_backward` wraps its backward, which replaces
  ``_lrn_bwd_kernel`` (B2) — ``dx = err·d^(−β) − 2αβ·x·Σ_adj(err·x·d^(−β−1))``
  over the window's adjoint (``[c − (n − 1 − n//2), c + n//2]``, not
  the forward's window when n is even), dx in err's dtype.

Each picks one of the source's two kernels by :func:`lrn_route`, a
rule on the channel count and the operands' addresses: the vector
kernels (8 channels a thread, 128-bit accesses) where they take the
shape, AlexNet's among them, the general kernels (any C, any n)
elsewhere.  Each counts its launches in all, by route
(``launches_by_route``), by channel count (``launches_by_channels``)
and by ``(rows, C)`` (``launches_by_shape``).

Dropout and the softmax head:

- :func:`dropout_apply` wraps ``csrc/dropout.cu``, which replaces
  ``_dropout_kernel`` (B3) — keep iff the element's Philox4x32-10 bits
  (counter = the element index, key = the seed) exceed
  ``ratio·(2³²−1)``, kept elements scaled by ``1/(1−ratio)``.  The
  plain version computes the same bits with int64 arithmetic, so a
  seed gives the same mask on the card and on the CPU.  The element
  index is the element's place in the global tensor that x is a block
  of (a :class:`BlockMap`: a process's rows under data parallelism,
  its columns after a column-parallel layer), so the processes of a
  mesh draw their parts of the one mask of the whole.  It picks one of
  the source's two kernels by :func:`dropout_route`: the vector kernel
  (8 elements a thread) where the operands lie on 16-byte boundaries
  and the map keeps 8-aligned runs whole, the general one elsewhere;
- :func:`softmax_argmax` wraps ``csrc/softmax_argmax.cu``, which
  replaces ``_softmax_argmax_kernel`` (B4) — the row softmax of f32
  logits and the int32 index of the first maximum.  It picks one of the
  source's two kernels by :func:`softmax_route`: the register kernel (a
  row in the registers of a group of up to 256 threads, several rows a
  warp at small C) up to :data:`SOFTMAX_REGISTER_MAX_CLASSES` classes,
  the general kernel (a block a row) past it.

Dropout counts its launches in all and by route, the softmax in all, by
route and by class count (``launches_by_classes``).

The layer norm, both directions:

- :func:`layer_norm_forward` wraps the CUDA kernel
  ``csrc/layer_norm_fwd.cu``, which replaces the Pallas TPU kernel
  ``_ln_fwd_kernel`` (B5) — f32 statistics over the last axis,
  ``(x − μ)·rsqrt(var + ε)·γ + β``, output stored in x's dtype, β
  optional;
- :func:`layer_norm_backward` wraps ``csrc/layer_norm_bwd.cu``, which
  replaces ``_ln_bwd_kernel`` (B6) — dx in err's dtype plus the f32
  cross-row γ and β gradient sums, in one pass over the rows.

Each picks one of its source's two kernels by :func:`layer_norm_route`,
a rule on the width and the operands' addresses: the register kernels
(a warp a row, the row held in registers) where they take the shape,
the sequence stack's D = 512 among them, the general kernels
elsewhere.  Each counts its launches in all, by route
(``launches_by_route``) and by x's dtype (``launches_by_dtype``).

"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops import _cuda, launch_counts

#: x dtypes the kernel takes → its dtype code
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_bound: set[str] = set()


def _lib(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` with its C signatures
    declared (pointers and the stream as ``c_void_p``, so ctypes never
    cuts a 64-bit address)."""
    lib = _cuda.library(stem)
    if stem not in _bound:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        signatures = {
            "layer_norm_fwd": {
                "znicz_layer_norm_fwd": ([p, p, p, p, ll, i, f, i, i, p], i),
                "znicz_layer_norm_fwd_reg": (
                    [p, p, p, p, ll, i, f, i, p], i)},
            "layer_norm_bwd": {
                "znicz_layer_norm_bwd_blocks": ([ll, i, i], ll),
                "znicz_layer_norm_bwd": (
                    [p, p, p, p, p, p, p, ll, i, f, i, i, i, p], i),
                "znicz_layer_norm_bwd_reg_blocks": ([ll], ll),
                "znicz_layer_norm_bwd_reg": (
                    [p, p, p, p, p, p, p, ll, i, f, i, i, p], i)},
            "lrn": {
                "znicz_lrn_fwd": ([p, p, ll, i, i, f, f, f, i, p], i),
                "znicz_lrn_bwd": ([p, p, p, ll, i, i, f, f, f, i, i, p], i),
                "znicz_lrn_fwd_vec": ([p, p, ll, i, i, f, f, f, i, p], i),
                "znicz_lrn_bwd_vec": (
                    [p, p, p, ll, i, i, f, f, f, i, i, p], i)},
            "dropout": {
                "znicz_dropout": (
                    [p, p, ll, ll, ll, ll, p, ll, f, i, p], i),
                "znicz_dropout_vec": (
                    [p, p, ll, ll, ll, ll, p, ll, f, i, p], i),
                "znicz_empty_launch": ([p], i)},
            "softmax_argmax": {
                "znicz_softmax_argmax": ([p, p, p, ll, i, p], i),
                "znicz_softmax_argmax_reg": ([p, p, p, ll, i, p], i)},
        }[stem]
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _bound.add(stem)
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_card_tensor(name: str, t: torch.Tensor, dtypes) -> None:
    """What the row kernels take on the card: a contiguous CUDA tensor
    of one of ``dtypes``."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"the kernel takes {list(dtypes)} for {name}, "
                         f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous {name}")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


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


#: elements of a vector of the layer-norm register kernels: one 16-byte
#: load in bf16, two in f32
LN_VECTOR = 8
#: the widest row the register kernels take: a warp holds a row, at most
#: 4 vectors a lane (what the registers hold without spilling)
LN_REGISTER_MAX_WIDTH = 32 * 4 * LN_VECTOR
#: the layer-norm kernels' launch counters by route (:func:`layer_norm_route`)
LN_ROUTES = ("register", "general")


def layer_norm_route(d: int, *pointers: int) -> str:
    """Which layer-norm kernel (either direction) takes rows of ``d``
    elements with operands at the addresses ``pointers``: ``"register"``
    when d is a multiple of :data:`LN_VECTOR` from 8 up to
    :data:`LN_REGISTER_MAX_WIDTH` and every pointer lies on a 16-byte
    boundary, else ``"general"``."""
    if (d % LN_VECTOR == 0 and LN_VECTOR <= d <= LN_REGISTER_MAX_WIDTH
            and all(p % 16 == 0 for p in pointers)):
        return "register"
    return "general"


def _count_ln(fn, route: str, x: torch.Tensor) -> None:
    """One launch of ``fn``'s kernel on ``route`` for an ``x`` of its
    dtype."""
    fn.launches += 1
    fn.launches_by_route[route] += 1
    fn.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1


def layer_norm_forward(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor | None,
                       eps: float) -> torch.Tensor:
    """Layer norm over the last axis of ``x`` (..., D) with f32 γ/β of
    shape (D,); the output has x's shape and dtype.  On the card x is
    contiguous f32 or bf16 and γ/β are contiguous f32, and
    :func:`layer_norm_route` picks the kernel."""
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return layer_norm_forward_plain(x, gamma, beta, eps)
    _check_card_tensor("x", x, _KERNEL_DTYPES)
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is not None and (p.dtype != torch.float32
                              or not p.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32")
    d = x.shape[-1]
    m = x.numel() // d if d else 0
    y = torch.empty_like(x)
    pointers = [t.data_ptr() for t in (x, y, gamma, beta) if t is not None]
    route = layer_norm_route(d, *pointers)
    lib = _lib("layer_norm_fwd")
    args = (x.data_ptr(), gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), y.data_ptr(), m, d,
            float(eps), _KERNEL_DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        if route == "register":
            err = lib.znicz_layer_norm_fwd_reg(*args, _stream(x))
        else:
            vec = int(d % 8 == 0 and all(p % 16 == 0 for p in pointers))
            err = lib.znicz_layer_norm_fwd(*args, vec, _stream(x))
    _raise_on(err, "layer_norm_forward")
    _count_ln(layer_norm_forward, route, x)
    return y


#: kernel launches since the counters were last set to 0: in all, by
#: route and by x's dtype
layer_norm_forward.launches = 0
layer_norm_forward.launches_by_route = dict.fromkeys(LN_ROUTES, 0)
layer_norm_forward.launches_by_dtype = collections.Counter()


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
    (each on its own) and γ is contiguous f32, and
    :func:`layer_norm_route` picks the kernel.  The cross-row sums are
    folded in an order fixed by the shape, so a rerun gives the same
    bits."""
    _check(x, gamma, None)
    if err.shape != x.shape or err.device != x.device:
        raise ValueError(f"err {tuple(err.shape)} on {err.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return layer_norm_backward_plain(x, err, gamma, eps, with_beta)
    _check_card_tensor("x", x, _KERNEL_DTYPES)
    _check_card_tensor("err", err, _KERNEL_DTYPES)
    if gamma.dtype != torch.float32 or not gamma.is_contiguous():
        raise ValueError("gamma must be contiguous float32")
    d = x.shape[-1]
    m = x.numel() // d if d else 0
    lib = _lib("layer_norm_bwd")
    dx = torch.empty_like(err)
    pointers = [t.data_ptr() for t in (x, err, dx, gamma)]
    route = layer_norm_route(d, *pointers)
    if route == "register":
        n_blocks = lib.znicz_layer_norm_bwd_reg_blocks(m)
    else:
        n_blocks = lib.znicz_layer_norm_bwd_blocks(m, d, int(with_beta))
    grad_g = torch.empty(d, dtype=torch.float32, device=x.device)
    grad_b = (torch.empty(d, dtype=torch.float32, device=x.device)
              if with_beta else None)
    work = torch.empty(max(n_blocks, 1) * d * (2 if with_beta else 1),
                       dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), err.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            grad_g.data_ptr(), None if grad_b is None else grad_b.data_ptr(),
            work.data_ptr(), m, d, float(eps), _KERNEL_DTYPES[x.dtype],
            _KERNEL_DTYPES[err.dtype])
    with torch.cuda.device(x.device):
        if route == "register":
            code = lib.znicz_layer_norm_bwd_reg(*args, _stream(x))
        else:
            vec = int(d % 8 == 0 and all(p % 16 == 0 for p in pointers))
            code = lib.znicz_layer_norm_bwd(*args, vec, _stream(x))
    _raise_on(code, "layer_norm_backward")
    _count_ln(layer_norm_backward, route, x)
    return dx, grad_g, grad_b


#: kernel launches since the counters were last set to 0: in all, by
#: route and by x's dtype
layer_norm_backward.launches = 0
layer_norm_backward.launches_by_route = dict.fromkeys(LN_ROUTES, 0)
layer_norm_backward.launches_by_dtype = collections.Counter()


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


# ----------------------------------------------------------------------
# LRN (B1, B2)
# ----------------------------------------------------------------------
#: channels a thread of the vector kernels owns: one 16-byte load in bf16
LRN_VECTOR = 8
#: the widest row the vector kernels take: a block of 256 threads, a
#: vector each, holds whole rows
LRN_VECTOR_MAX_CHANNELS = 256 * LRN_VECTOR
#: the LRN kernels' launch counters by route (:func:`lrn_route`)
LRN_ROUTES = ("vector", "general")
#: route → (forward, backward) C entry point of ``csrc/lrn.cu``
_LRN_ENTRY = {"vector": ("znicz_lrn_fwd_vec", "znicz_lrn_bwd_vec"),
              "general": ("znicz_lrn_fwd", "znicz_lrn_bwd")}


def _window_sum(a: torch.Tensor, n: int, half_low: int) -> torch.Tensor:
    """Sliding sum over the last axis, ``out_c = Σ_{j=c−half_low}^{c+n−1−half_low} a_j``
    (zero outside), added in channel order as the kernels add it."""
    c = a.shape[-1]
    padded = F.pad(a, (half_low, n - 1 - half_low))
    out = torch.zeros_like(a)
    for off in range(n):
        out = out + padded[..., off:off + c]
    return out


def _pow_neg(d: torch.Tensor, beta: float) -> torch.Tensor:
    """``d^(−β)``; AlexNet's β = 0.75 as ``rsqrt(d·√d)``, as the kernel
    and the reference's XLA path compute it."""
    if beta == 0.75:
        return torch.rsqrt(d * torch.sqrt(d))
    return d ** (-beta)


def _check_lrn(x: torch.Tensor, n: int) -> None:
    if x.dim() < 1 or n < 1:
        raise ValueError(f"LRN over the last axis of a tensor with n >= 1, "
                         f"got shape {tuple(x.shape)} and n={n}")


def lrn_route(c: int, *pointers: int) -> str:
    """Which LRN kernel takes ``C`` channels and operands at the addresses
    ``pointers``: ``"vector"`` when C is a multiple of
    :data:`LRN_VECTOR` up to :data:`LRN_VECTOR_MAX_CHANNELS` and every
    pointer lies on a 16-byte boundary, else ``"general"`` (any C;
    any n goes either way)."""
    if (c % LRN_VECTOR == 0 and c <= LRN_VECTOR_MAX_CHANNELS
            and all(p % 16 == 0 for p in pointers)):
        return "vector"
    return "general"


def _lrn_rows(x: torch.Tensor) -> tuple[int, int]:
    """``(rows, C)`` of a tensor the LRN kernels take: contiguous f32 or
    bf16 on the card."""
    _check_card_tensor("x", x, _KERNEL_DTYPES)
    c = x.shape[-1]
    return (x.numel() // c if c else 0), c


def _count_lrn(fn, route: str, rows: int, c: int) -> None:
    """One launch of ``fn``'s kernel on ``route`` for ``rows`` rows of
    ``c`` channels."""
    fn.launches += 1
    fn.launches_by_route[route] += 1
    fn.launches_by_channels[c] += 1
    fn.launches_by_shape[rows, c] += 1


def lrn_forward(x: torch.Tensor, alpha: float, beta: float, k: float,
                n: int) -> torch.Tensor:
    """Cross-channel LRN over the last axis of ``x``: y with x's shape
    and dtype.  On the card x is contiguous f32 or bf16, and
    :func:`lrn_route` picks the kernel."""
    _check_lrn(x, n)
    if x.device.type == "cpu":
        return lrn_forward_plain(x, alpha, beta, k, n)
    rows, c = _lrn_rows(x)
    y = torch.empty_like(x)
    route = lrn_route(c, x.data_ptr(), y.data_ptr())
    with torch.cuda.device(x.device):
        err = getattr(_lib("lrn"), _LRN_ENTRY[route][0])(
            x.data_ptr(), y.data_ptr(), rows, c, n, alpha, beta, k,
            _KERNEL_DTYPES[x.dtype], _stream(x))
    _raise_on(err, "lrn_forward")
    _count_lrn(lrn_forward, route, rows, c)
    return y


#: kernel launches since the counters were last set to 0: in all, by
#: route, by channel count and by (rows, C)
lrn_forward.launches = 0
lrn_forward.launches_by_route = dict.fromkeys(LRN_ROUTES, 0)
lrn_forward.launches_by_channels = collections.Counter()
lrn_forward.launches_by_shape = collections.Counter()


def lrn_forward_plain(x: torch.Tensor, alpha: float, beta: float, k: float,
                      n: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch (f32 math, y in
    x's dtype)."""
    _check_lrn(x, n)
    xf = x.float()
    d = k + alpha * _window_sum(xf * xf, n, n // 2)
    return (xf * _pow_neg(d, beta)).to(x.dtype)


def lrn_backward(x: torch.Tensor, err: torch.Tensor, alpha: float,
                 beta: float, k: float, n: int) -> torch.Tensor:
    """The LRN's analytic gradient: dx with x's shape in err's dtype.
    On the card x and err are contiguous f32 or bf16 (each on its own),
    and :func:`lrn_route` picks the kernel."""
    _check_lrn(x, n)
    if err.shape != x.shape or err.device != x.device:
        raise ValueError(f"err {tuple(err.shape)} on {err.device} does not "
                         f"match x {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return lrn_backward_plain(x, err, alpha, beta, k, n)
    _check_card_tensor("err", err, _KERNEL_DTYPES)
    rows, c = _lrn_rows(x)
    dx = torch.empty_like(err)
    route = lrn_route(c, x.data_ptr(), err.data_ptr(), dx.data_ptr())
    with torch.cuda.device(x.device):
        code = getattr(_lib("lrn"), _LRN_ENTRY[route][1])(
            x.data_ptr(), err.data_ptr(), dx.data_ptr(), rows, c, n, alpha,
            beta, k, _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[err.dtype],
            _stream(x))
    _raise_on(code, "lrn_backward")
    _count_lrn(lrn_backward, route, rows, c)
    return dx


#: kernel launches since the counters were last set to 0: in all, by
#: route, by channel count and by (rows, C)
lrn_backward.launches = 0
lrn_backward.launches_by_route = dict.fromkeys(LRN_ROUTES, 0)
lrn_backward.launches_by_channels = collections.Counter()
lrn_backward.launches_by_shape = collections.Counter()


def lrn_backward_plain(x: torch.Tensor, err: torch.Tensor, alpha: float,
                       beta: float, k: float, n: int) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch (f32 math, dx in
    err's dtype)."""
    _check_lrn(x, n)
    xf, ef = x.float(), err.float()
    d = k + alpha * _window_sum(xf * xf, n, n // 2)
    p = _pow_neg(d, beta)
    t = ef * xf * (p / d)
    dx = ef * p - 2.0 * alpha * beta * xf * _window_sum(t, n,
                                                        n - 1 - n // 2)
    return dx.to(err.dtype)


# ----------------------------------------------------------------------
# dropout (B3)
# ----------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` 32-bit words of the 64-bit product of the constant
    ``m`` and the 32-bit values in the int64 tensor ``c``, through 16-bit
    halves so no int64 product overflows."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    c_hi, c_lo = c >> 16, c & 0xFFFF
    low = m_lo * c_lo
    mid = m_hi * c_lo + m_lo * c_hi
    lo = low + ((mid & 0xFFFF) << 16)
    hi = m_hi * c_hi + (mid >> 16) + (lo >> 32)
    return hi & _M32, lo & _M32


class BlockMap(NamedTuple):
    """Where a ``(rows, cols)`` block lies in the global ``(rows', c_glob)``
    tensor it is a part of: its first row ``row0`` and first column
    ``col0``.  Local element ``(r, c)`` is global element ``(row0 + r) ·
    c_glob + col0 + c``.  None in its place is the identity (the block
    is the whole)."""

    row0: int
    col0: int
    c_glob: int


def map_args(rows: int, cols: int, block: BlockMap | None
             ) -> tuple[int, int]:
    """``(base, c_glob)`` of ``block`` for a ``(rows, cols)`` block: the
    global index of its first element and the global width (the
    identity's: 0 and the block's own width); raises for a map that
    does not hold the block."""
    if block is None:
        return 0, cols
    row0, col0, c_glob = (int(v) for v in block)
    if row0 < 0 or col0 < 0 or col0 + cols > c_glob \
            or (cols == c_glob and col0):
        raise ValueError(f"block map {tuple(block)} cannot hold a "
                         f"({rows}, {cols}) block")
    return row0 * c_glob + col0, c_glob


def block_indices(rows: int, cols: int, block: BlockMap | None = None,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """The global indices of a ``(rows, cols)`` block under ``block``
    (int64, ``(rows, cols)``)."""
    base, c_glob = map_args(rows, cols, block)
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return base + r * c_glob + c


def block_bits(rows: int, cols: int, seed, device: torch.device | str
               = "cpu", block: BlockMap | None = None) -> torch.Tensor:
    """:func:`dropout_bits` of a ``(rows, cols)`` block's elements under
    ``block``, ``(rows, cols)``: with no map, ``dropout_bits(rows·cols)``
    bit for bit."""
    return philox_bits(block_indices(rows, cols, block, device), seed)


def dropout_bits(n: int, seed, device: torch.device | str = "cpu",
                 start: int = 0) -> torch.Tensor:
    """The 32-bit random words of elements ``start..start+n−1`` (as
    int64): :func:`philox_bits` of those indices."""
    return philox_bits(torch.arange(start, start + n, dtype=torch.int64,
                                    device=device), seed)


def philox_bits(i: torch.Tensor, seed) -> torch.Tensor:
    """The 32-bit random words of the elements of global indices ``i``
    (int64): word 0 of Philox4x32-10 at counter ``(i mod 2³², i div
    2³², 0, 0)`` and key ``(seed mod 2³², seed div 2³²)``, the
    arithmetic of ``csrc/dropout.cu`` on int64 tensors masked to 32
    bits (``seed`` an int or a 0-d int64 tensor)."""
    c0, c1 = i & _M32, i >> 32
    c2 = torch.zeros_like(i)
    c3 = torch.zeros_like(i)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0


@functools.lru_cache(maxsize=None)
def _dropout_constants(dtype: torch.dtype, drop_ratio: float
                       ) -> tuple[int, float]:
    """``(threshold, scale)``: keep iff bits > threshold (the TPU
    kernel's ``ratio·(2³²−1)``, −1 for ratio 0 so that every element is
    kept), kept elements times ``1/(1−ratio)`` rounded to x's dtype, as
    the reference's mask is stored in it."""
    if not 0.0 <= drop_ratio < 1.0:
        raise ValueError(f"drop_ratio {drop_ratio} not in [0, 1)")
    threshold = int(drop_ratio * (2 ** 32 - 1)) if drop_ratio else -1
    scale = float(torch.tensor(1.0 / (1.0 - drop_ratio)).to(dtype))
    return threshold, scale


#: the dropout kernel's launch counters by route (:func:`dropout_route`)
DROPOUT_ROUTES = ("vector", "general")
#: route → C entry point of ``csrc/dropout.cu``
_DROPOUT_ENTRY = {"vector": "znicz_dropout_vec", "general": "znicz_dropout"}


def dropout_route(*pointers: int, cols: int | None = None,
                  block: BlockMap | None = None) -> str:
    """Which dropout kernel takes operands at the addresses ``pointers``,
    a block ``cols`` wide under ``block``: ``"vector"`` (8 elements a
    thread, 16-byte accesses; any size, the last short run element by
    element) when every pointer lies on a 16-byte boundary and each
    8-aligned run of the block's elements is a run of 8 global indices
    from a multiple of 8 (the identity always; a block of whole rows
    whose first index is a multiple of 8; a block of columns whose
    width, first column and global width are multiples of 8), else
    ``"general"``."""
    if not all(p % 16 == 0 for p in pointers):
        return "general"
    if block is None:
        return "vector"
    base, c_glob = map_args(0, cols, block)
    whole = cols == c_glob
    return "vector" if base % 8 == 0 and (
        whole or (cols % 8 == 0 and c_glob % 8 == 0)) else "general"


def block_shape(x: torch.Tensor) -> tuple[int, int]:
    """x as the ``(rows, cols)`` view the block map reads: dim 0 by the
    rest (a 0-d or 1-d tensor one row)."""
    rows = x.shape[0] if x.dim() > 1 else 1
    return rows, x.numel() // max(rows, 1)


def seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` as the 0-d int64 device tensor the dropout kernel reads:
    a tensor on ``device`` as it is, a Python int through a fill (its
    value is then part of the call: frozen in a captured graph)."""
    if isinstance(seed, torch.Tensor):
        if seed.device != torch.device(device) or seed.dtype != torch.int64:
            raise ValueError(f"dropout seed: an int64 tensor on {device}, "
                             f"got {seed.dtype} on {seed.device}")
        return seed.reshape(())
    value = int(seed) & (2 ** 64 - 1)
    return torch.full((), value - 2 ** 64 if value >= 2 ** 63 else value,
                      dtype=torch.int64, device=device)


def _seed_value(seed) -> int:
    """The seed as the unsigned 64-bit key (host code only)."""
    return int(seed) & (2 ** 64 - 1)


def dropout_apply(x: torch.Tensor, seed, drop_ratio: float,
                  block: BlockMap | None = None) -> torch.Tensor:
    """Inverted dropout with the mask of ``seed``: y with x's shape and
    dtype.  The same seed gives the same mask for any tensor of the
    same size (the backward applies it to the error).  ``seed`` is a
    Python int or a 0-d int64 tensor on x's device; the kernel reads it
    through a pointer, so a seed tensor that the step advances gives
    each replay of a captured graph its own mask.  ``block`` places x,
    read as :func:`block_shape`, in the global tensor whose mask it
    draws a part of (None: x is the whole).  On the card x is
    contiguous f32 or bf16, and :func:`dropout_route` picks the
    kernel."""
    threshold, scale = _dropout_constants(x.dtype, drop_ratio)
    rows, cols = block_shape(x)
    base, c_glob = map_args(rows, cols, block)
    if x.device.type == "cpu":
        return dropout_apply_plain(x, seed, drop_ratio, block)
    _check_card_tensor("x", x, _KERNEL_DTYPES)
    seed_t = seed_tensor(seed, x.device)
    y = torch.empty_like(x)
    route = dropout_route(x.data_ptr(), y.data_ptr(), cols=cols,
                          block=block)
    with torch.cuda.device(x.device):
        err = getattr(_lib("dropout"), _DROPOUT_ENTRY[route])(
            x.data_ptr(), y.data_ptr(), x.numel(), max(cols, 1), base,
            max(c_glob, 1), seed_t.data_ptr(), threshold, scale,
            _KERNEL_DTYPES[x.dtype], _stream(x))
    _raise_on(err, "dropout_apply")
    dropout_apply.launches += 1
    dropout_apply.launches_by_route[route] += 1
    return y


#: kernel launches since the counters were last set to 0: in all and by
#: route
dropout_apply.launches = 0
dropout_apply.launches_by_route = dict.fromkeys(DROPOUT_ROUTES, 0)


def dropout_apply_plain(x: torch.Tensor, seed, drop_ratio: float,
                        block: BlockMap | None = None) -> torch.Tensor:
    """The dropout kernel's function in plain PyTorch, bit for bit
    (``seed``: an int, or a 0-d int64 tensor read on the host)."""
    threshold, scale = _dropout_constants(x.dtype, drop_ratio)
    rows, cols = block_shape(x)
    keep = block_bits(rows, cols, _seed_value(seed), x.device,
                      block).reshape(x.shape) > threshold
    return torch.where(keep, x.float() * scale, 0.0).to(x.dtype)


# ----------------------------------------------------------------------
# softmax + argmax (B4)
# ----------------------------------------------------------------------
def _check_logits(v: torch.Tensor) -> None:
    if v.dim() != 2:
        raise ValueError(f"softmax_argmax takes (rows, classes) logits, "
                         f"got shape {tuple(v.shape)}")


#: the widest row the register kernel takes: 256 threads hold it, 4
#: elements each
SOFTMAX_REGISTER_MAX_CLASSES = 1024
#: the softmax kernel's launch counters by route (:func:`softmax_route`)
SOFTMAX_ROUTES = ("register", "general")


def softmax_route(c: int) -> str:
    """Which softmax kernel takes rows of ``c`` classes: ``"register"``
    up to :data:`SOFTMAX_REGISTER_MAX_CLASSES` (128-bit loads past 256
    classes where C % 4 == 0 and the rows lie on 16-byte boundaries,
    scalar ones otherwise), else ``"general"``."""
    return ("register" if c <= SOFTMAX_REGISTER_MAX_CLASSES
            else "general")


def softmax_argmax(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row softmax and argmax of (rows, C) logits: ``(probabilities f32,
    max_idx int32)``, the first index on ties.  On the card v is
    contiguous f32, and :func:`softmax_route` picks the kernel."""
    _check_logits(v)
    if v.device.type == "cpu":
        return softmax_argmax_plain(v)
    _check_card_tensor("v", v, (torch.float32,))
    rows, c = v.shape
    y = torch.empty_like(v)
    idx = torch.empty(rows, dtype=torch.int32, device=v.device)
    route = softmax_route(c)
    lib = _lib("softmax_argmax")
    args = (v.data_ptr(), y.data_ptr(), idx.data_ptr(), rows, c)
    with torch.cuda.device(v.device):
        if route == "register":
            err = lib.znicz_softmax_argmax_reg(*args, _stream(v))
        else:
            err = lib.znicz_softmax_argmax(*args, _stream(v))
    _raise_on(err, "softmax_argmax")
    softmax_argmax.launches += 1
    softmax_argmax.launches_by_route[route] += 1
    softmax_argmax.launches_by_classes[c] += 1
    return y, idx


#: kernel launches since the counters were last set to 0: in all, by route
#: and by class count
softmax_argmax.launches = 0
softmax_argmax.launches_by_route = dict.fromkeys(SOFTMAX_ROUTES, 0)
softmax_argmax.launches_by_classes = collections.Counter()


def softmax_argmax_plain(v: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``exp(v − max)`` over its
    row sum in f32, and ``argmax`` of v (first index on ties)."""
    _check_logits(v)
    vf = v.float()
    e = torch.exp(vf - vf.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True), torch.argmax(vf, dim=1).to(
        torch.int32)


launch_counts.register(layer_norm_forward, layer_norm_backward, lrn_forward,
                       lrn_backward, dropout_apply, softmax_argmax)
