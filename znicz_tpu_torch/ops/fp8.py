"""The ``engine.fp8_matmul`` lever: products on e4m3 operands with an f32
result (port of the reference's fp8 ``mxu_dot``,
``znicz_tpu/accelerated_units.py``, and of its gradient round-trip,
``znicz_tpu/ops/nn_units.py``).

- :func:`q8` is the one cast to ``float8_e4m3fn`` the port makes, with
  the reference's overflow: the reference's cast turns every |x| > 464,
  and ±inf, into NaN (464 itself rounds to 448), where torch's
  ``.to(torch.float8_e4m3fn)`` saturates to ±448.
- :func:`fp8_matmul` multiplies two e4m3 matrices into f32: on the card
  through ``torch._scaled_mm`` (Hopper's fp8 tensor cores, unit f32
  scales), which takes K and N in multiples of 16 and the second
  operand column-major, so both are zero-padded (exact) and the result
  sliced; a shape or build it refuses raises, with no fallback.  On the
  CPU it is the plain version, an f32 product of the e4m3 values, exact
  up to summation order (any two e4m3 values multiply exactly in f32).
  The reference computes the product with XLA, outside any Pallas
  kernel, so a library GEMM stands for it here.
- :class:`Fp8Dot` is ``q8(a) @ q8(b)`` made differentiable with the
  rule ``jax.vjp`` gives the reference's product: ``da = q8(g @ q8(b)ᵀ)``
  and ``db = q8(q8(a)ᵀ @ g)``, each cast back to its operand's dtype.
  ``g`` stays f32 there, so the two backward products are plain f32
  products of ``g`` with the e4m3 values, on every device (a
  ``_scaled_mm`` would round ``g`` to fp8 too, which the reference
  does not).

Both fp8 routes count their calls (``fp8_matmul.launches``,
``fp8_matmul.launches_by_route``) through
:mod:`~znicz_tpu_torch.ops.launch_counts`, so a replayed graph counts
them as the kernels' wrappers do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.utils.config import register_defaults, root

register_defaults("common", {"engine": {"fp8_matmul": False}})

FP8 = torch.float8_e4m3fn
#: the reference's cast gives NaN past this magnitude (464 rounds to 448)
OVERFLOW = 464.0
#: ``_scaled_mm``'s multiple for K and N
_ALIGN = 16
#: the unit scales ``_scaled_mm`` takes, one pair a device, made on the
#: first (eager) call, so before any capture
_SCALES: dict = {}


def fp8_enabled() -> bool:
    """``root.common.engine.fp8_matmul`` (default off)."""
    return bool(root.common.engine.get("fp8_matmul", False))


def q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``float8_e4m3fn`` with the reference's overflow: NaN
    where |x| > 464 or x is ±inf, round to nearest even elsewhere."""
    return torch.where(x.abs() > OVERFLOW, float("nan"), x).to(FP8)


def _pad8(x8: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """An e4m3 matrix zero-padded to (rows, cols) (through its bytes:
    the zero byte is +0.0)."""
    r, c = x8.shape
    if (r, c) == (rows, cols):
        return x8
    return F.pad(x8.view(torch.uint8), (0, cols - c, 0, rows - r)).view(FP8)


def fp8_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """``a8 @ b8`` of two 2-D e4m3 matrices, an f32 result."""
    fp8_matmul.launches += 1
    if a8.device.type != "cuda":
        fp8_matmul.launches_by_route["plain"] += 1
        return a8.float() @ b8.float()
    fp8_matmul.launches_by_route["scaled_mm"] += 1
    m, k = a8.shape
    n = b8.shape[1]
    kp = -(-k // _ALIGN) * _ALIGN
    npad = -(-n // _ALIGN) * _ALIGN
    scale = _SCALES.get(a8.device)
    if scale is None:
        scale = _SCALES[a8.device] = torch.ones((), dtype=torch.float32,
                                                device=a8.device)
    # the second operand column-major: the transpose of a row-major one
    b_cm = _pad8(b8.t().contiguous(), npad, kp).t()
    out = torch._scaled_mm(_pad8(a8.contiguous(), m, kp), b_cm,
                           scale_a=scale, scale_b=scale,
                           out_dtype=torch.float32)
    return out if npad == n else out[:, :n]


fp8_matmul.launches = 0
fp8_matmul.launches_by_route = {"scaled_mm": 0, "plain": 0}
launch_counts.register(fp8_matmul)


class Fp8Dot(torch.autograd.Function):
    """``q8(a) @ q8(b)`` in f32, with the reference's cotangents."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a8, b8 = q8(a), q8(b)
        ctx.save_for_backward(a8, b8)
        ctx.dtypes = (a.dtype, b.dtype)
        return fp8_matmul(a8, b8)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a8, b8 = ctx.saved_tensors
        g = g.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = q8(g @ b8.float().t()).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            db = q8(a8.float().t() @ g).to(ctx.dtypes[1])
        return da, db


def fp8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:class:`Fp8Dot` of two 2-D operands."""
    return Fp8Dot.apply(a, b)


def fp8_round_trip(grad: torch.Tensor) -> torch.Tensor:
    """A gradient at the precision the fp8 arm would store it: through
    :func:`q8` and back to f32."""
    return q8(grad).float()
