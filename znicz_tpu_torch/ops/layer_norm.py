"""Layer normalization unit and its backward (port of
``znicz_tpu/ops/layer_norm.py``).

``y = γ · (x − μ) / √(σ² + ε) + β`` over the last (feature) axis, with
γ/β in the bundle's ``weights``/``bias`` (shape (D,), f32, initially
ones and zeros).  The statistics are f32 even under bf16 activation
storage; the output is stored at the activation dtype.  The forward is
the fused kernel
:func:`~znicz_tpu_torch.ops.fused_kernels.layer_norm_forward` and
``GDLayerNorm`` calls the backward kernel
:func:`~znicz_tpu_torch.ops.fused_kernels.layer_norm_backward` directly,
as the reference's ``GDLayerNorm`` does: dx in err's dtype and the f32
γ/β sums in one pass.  On the CPU both take their plain versions.  On
the numpy oracle the pair runs the reference's numpy math.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.fused_kernels import (layer_norm_backward,
                                               layer_norm_forward)
from znicz_tpu_torch.ops.nn_units import Forward, GradientDescentBase


class LayerNorm(Forward):
    """Per-position feature normalization with learned scale/shift."""

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 eps: float = 1e-5, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.eps = float(eps)

    def param_shapes(self) -> dict[str, tuple]:
        d = self.input_shape[-1]
        shapes = {"weights": (d,)}
        if self.include_bias:
            shapes["bias"] = (d,)
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        d = self.input_shape[-1]
        params = {"weights": np.ones(d, np.float32)}
        if self.include_bias:
            params["bias"] = np.zeros(d, np.float32)
        return params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = self.bias if self.include_bias else None
        y = layer_norm_forward(x, self.weights, beta, self.eps)
        return y.to(self.output_store_dtype)

    def normalize_np(self, x: np.ndarray):
        """``(x̂, σ²)`` over the last axis (the reference's numpy)."""
        mu = x.mean(axis=-1, keepdims=True)
        var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
        return (x - mu) / np.sqrt(var + self.eps), var

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        xhat, _ = self.normalize_np(x.astype(np.float32))
        y = self.np_param("weights") * xhat
        return y + self.np_param("bias") if self.include_bias else y


class GDLayerNorm(GradientDescentBase):
    """Analytic layer-norm backward through the fused kernel:

    .. code-block:: text

        dβ = Σ err          dγ = Σ err·x̂
        dx = (err·γ − mean(err·γ) − x̂·mean(err·γ·x̂)) / √(σ² + ε)
    """

    MATCHES = (LayerNorm,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        dx, grad_g, grad_b = layer_norm_backward(
            x, err_output, fwd.weights, fwd.eps,
            with_beta=fwd.include_bias)
        self.apply_weights(grad_g)
        if fwd.include_bias:
            self.apply_bias(grad_b)
        if not self.need_err_input:
            return None
        return dx.to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        fwd = self.forward_unit
        x = x.astype(np.float32)
        err = err_output.astype(np.float32)
        xhat, var = fwd.normalize_np(x)
        axes = tuple(range(x.ndim - 1))
        dxhat = err * fwd.np_param("weights")
        dx = (dxhat - dxhat.mean(axis=-1, keepdims=True)
              - xhat * (dxhat * xhat).mean(axis=-1, keepdims=True)) \
            / np.sqrt(var + fwd.eps)
        grad_b = err.sum(axis=axes) if fwd.include_bias else None
        self.numpy_apply_weights((err * xhat).sum(axis=axes))
        if fwd.include_bias:
            self.numpy_apply_bias(grad_b)
        return dx if self.need_err_input else None
