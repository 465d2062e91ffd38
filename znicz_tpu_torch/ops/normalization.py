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
port follows the reference's Pallas kernels, which do not.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.ops.fused_kernels import lrn_backward, lrn_forward
from znicz_tpu_torch.ops.nn_units import Forward, WeightlessGradientUnit


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
