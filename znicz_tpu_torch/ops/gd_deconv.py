"""Transposed-convolution backward unit (port of
``znicz_tpu/ops/gd_deconv.py``).

The reference takes the gradients without running the forward again:
the activation derivative from the saved output, the input's gradient
as the paired forward conv of δ, the weights' through
``jax.linear_transpose`` of the transposed conv in its weight argument.
The port does the same, with cuDNN on the card:

.. code-block:: text

    δ         = err_output · act'(y)              storage dtype
    err_input = conv(δ, W)                        conv dtype, then stored
    dL/dW     = filter_grad(input δ, cotangent x) conv dtype, then f32
    dL/db     = Σ_{n,h,w} δ                       f32

``⟨deconv(x, W), δ⟩ = ⟨x, conv(δ, W)⟩``, so the weights' gradient is
the filter gradient of the paired conv taken at δ with x as its output's
cotangent: one ``aten.convolution_backward`` call.  In bf16 mode δ is
rounded to bf16 before both products and each gives a bf16 result
before the f32 cast, as the reference's.  Then the shared update of
:class:`~znicz_tpu_torch.ops.nn_units.GradientDescentBase`; a deconv
whose weights are tied to its conv's updates that one tensor in place
(before the conv's own backward does, the backward running from the
last layer to the first), with momentum of its own.

On the numpy oracle the gradients are the reference's explicit
products: im2col of δ times the weights, and its transpose times x.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.conv import im2col
from znicz_tpu_torch.ops.deconv import Deconv
from znicz_tpu_torch.ops.nn_units import GradientDescentBase


class GDDeconv(GradientDescentBase):
    """Backward of every ``Deconv`` flavor (the derivative is the
    forward's activation's)."""

    MATCHES = (Deconv,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        w = fwd.weights
        delta = err_output * fwd.activation.derivative(y, None)
        dc, wc, pad = fwd.nchw_operands(delta, w)
        xc = x.to(fwd.conv_dtype()).permute(0, 3, 1, 2)
        _, grad_w, _ = torch.ops.aten.convolution_backward(
            xc, dc, wc, None, list(fwd.sliding), list(pad), [1, 1], False,
            [0, 0], 1, [False, True, False])
        err_input = None
        if self.need_err_input:
            # the paired conv, from the weights as they were before the
            # step
            err_input = F.conv2d(
                dc, wc, stride=fwd.sliding, padding=pad).permute(
                0, 2, 3, 1).float().to(self.act_store_dtype).contiguous()
        self.apply_weights(grad_w.permute(2, 3, 1, 0).float())
        if fwd.include_bias:
            self.apply_bias(delta.float().sum(dim=(0, 1, 2)))
        return err_input

    def numpy_backprop(self, x, err_output, y=None):
        fwd = self.forward_unit
        x = x.astype(np.float32)
        w = fwd.np_param("weights")
        k = x.shape[-1]
        w2d = w.reshape(-1, k)                       # (ky*kx*C, K)
        delta = err_output * fwd.activation.np_derivative(y, None)
        ecols = im2col(delta, fwd.ky, fwd.kx, *fwd.sliding, fwd.padding)
        ecols2d = ecols.reshape(-1, ecols.shape[-1])
        err_input = None
        if self.need_err_input:
            err_input = (ecols2d @ w2d).reshape(x.shape)
        grad_w = (ecols2d.T @ x.reshape(-1, k)).reshape(w.shape)
        self.numpy_apply_weights(grad_w)
        if fwd.include_bias:
            self.numpy_apply_bias(delta.sum(axis=(0, 1, 2)))
        return err_input
