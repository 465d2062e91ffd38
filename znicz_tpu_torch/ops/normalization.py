"""Local response normalization across channels, AlexNet-style (port of
``znicz_tpu/ops/normalization.py``).

.. code-block:: text

    d_i = k + α·Σ_{j∈window(i)} x_j²        (window = n channels)
    y_i = x_i · d_i^{−β}

Defaults are the reference's and AlexNet's: α=1e-4, β=0.75, k=2, n=5.
Activations are channels-last, so the channel axis is the last and the
kernels read (rows, C) rows with no copy.

``LRNormalizerForward`` runs the LRN forward kernel
(:func:`~znicz_tpu_torch.ops.fused_kernels.lrn_forward`) and
``LRNormalizerBackward`` the analytic-gradient kernel
(:func:`~znicz_tpu_torch.ops.fused_kernels.lrn_backward`), whose second
window sum is the window operator's adjoint; the math is f32 on stored
bf16 or f32 activations, and nothing is kept between the two: the
backward recomputes d from x.  On the CPU both take their plain
versions.  The reference's XLA path rounds d to bf16 in bf16 mode; the
port follows the reference's Pallas kernels, which do not.  On the
numpy oracle the pair runs the reference's numpy path: the window as a
shifted-add sum and the analytic gradient written out.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.fused_kernels import lrn_backward, lrn_forward
from znicz_tpu_torch.ops.nn_units import Forward, WeightlessGradientUnit


def window_sum_np(arr: np.ndarray, n: int,
                  half_low: int | None = None) -> np.ndarray:
    """The sliding sum over the last (channel) axis,
    ``out_i = Σ_{k=i−half_low}^{i+(n−1−half_low)} arr_k`` zero-padded
    (``half_low`` n//2 by default; the adjoint's is n−1−n//2): the
    reference's numpy shifted-add form, copied."""
    c = arr.shape[-1]
    if half_low is None:
        half_low = n // 2
    half_high = n - 1 - half_low
    padded = np.concatenate(
        [np.zeros(arr.shape[:-1] + (half_low,), arr.dtype), arr,
         np.zeros(arr.shape[:-1] + (half_high,), arr.dtype)], axis=-1)
    out = np.zeros_like(arr)
    for off in range(n):
        out = out + padded[..., off:off + c]
    return out


def pow_neg_beta_np(d: np.ndarray, beta: float) -> np.ndarray:
    """``d ** (-beta)`` through the reference's sqrt chains for the
    quarter powers (its numpy forms, copied)."""
    if beta == 0.75:
        return (d * np.sqrt(d)) ** -0.5
    if beta == 0.5:
        return d ** -0.5
    if beta == 0.25:
        return np.sqrt(d) ** -0.5
    if beta == 1.0:
        return 1.0 / d
    return d ** (-beta)


class LRNormalizerForward(Forward):
    """Across-channel LRN (weightless forward)."""

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 alpha: float = 1e-4, beta: float = 0.75, k: float = 2.0,
                 n: int = 5, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.k = float(k)
        self.n = int(n)

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = lrn_forward(x.contiguous(), self.alpha, self.beta, self.k,
                        self.n)
        return y.to(self.output_store_dtype)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        d = self.k + self.alpha * window_sum_np(x * x, self.n)
        return x * pow_neg_beta_np(d, self.beta)


class LRNormalizerBackward(WeightlessGradientUnit):
    """The LRN's analytic gradient through the fused kernel (weightless:
    nothing to update)."""

    MATCHES = (LRNormalizerForward,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        fwd = self.forward_unit
        dx = lrn_backward(x.contiguous(), err_output.contiguous(),
                          fwd.alpha, fwd.beta, fwd.k, fwd.n)
        return dx.to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        """The reference's analytic gradient:
        ``dy_i/dx_j = δ_ij·d_i^{−β} − 2αβ·x_i·x_j·d_i^{−β−1}·[j∈win(i)]``,
        the second sum through the window operator's adjoint."""
        if not self.need_err_input:
            return None
        fwd = self.forward_unit
        x = x.astype(np.float32)
        d = fwd.k + fwd.alpha * window_sum_np(x * x, fwd.n)
        t = err_output * x * d ** (-fwd.beta - 1.0)
        return err_output * d ** (-fwd.beta) - 2.0 * fwd.alpha * fwd.beta \
            * x * window_sum_np(t, fwd.n, half_low=fwd.n - 1 - fwd.n // 2)
