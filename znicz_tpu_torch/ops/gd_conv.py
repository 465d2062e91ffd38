"""Convolution backward units (port of ``znicz_tpu/ops/gd_conv.py``).

The reference takes the two gradient convolutions as
``jax.linear_transpose`` of the forward's bare conv, without running the
forward again, and the activation derivative from the forward's saved
output.  The port does the same with one
``aten.convolution_backward`` call on the forward's operands (cuDNN's
data- and filter-gradient convolutions on the card): the forward is
not re-run.

.. code-block:: text

    δ         = err_output · act'(y)       storage dtype
    err_input = conv_transpose(δ, W)       at the conv dtype, then stored
    dL/dW     = conv_filter_grad(x, δ)     at the conv dtype, then f32
    dL/db     = Σ_{n,h,w} δ                f32

Rounding points are the reference's: in bf16 mode δ is rounded to bf16
before both gradient convolutions, and each gives a bf16 result before
the f32 cast.  Then the shared update of
:class:`~znicz_tpu_torch.ops.nn_units.GradientDescentBase`.  On the
numpy oracle the gradients are the reference's explicit im2col
products and col2im.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.conv import (Conv, ConvRELU, ConvSigmoid,
                                      ConvStrictRELU, ConvTanh, col2im)
from znicz_tpu_torch.ops.nn_units import GradientDescentBase


class GradientDescentConv(GradientDescentBase):
    """Backward of the linear ``Conv``."""

    MATCHES = (Conv,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        act = fwd.activation
        delta = err_output
        if act.name != "linear":
            delta = delta * act.derivative(y, x if act.needs_input else None)
        xc, wc, pad = fwd.nchw_operands(x, fwd.weights)
        cot = delta.to(fwd.conv_dtype()).permute(0, 3, 1, 2)
        grad_x, grad_w, _ = torch.ops.aten.convolution_backward(
            cot, xc, wc, None, list(fwd.sliding), list(pad), [1, 1], False,
            [0, 0], 1, [self.need_err_input, True, False])
        self.apply_weights(grad_w.permute(2, 3, 1, 0).float())
        if fwd.include_bias:
            self.apply_bias(delta.float().sum(dim=(0, 1, 2)))
        if not self.need_err_input:
            return None
        if not fwd.even_padding:
            # the gradient of the padded input, cut back to x
            pt, _, pl, _ = fwd.padding
            grad_x = grad_x[:, :, pt:pt + x.shape[1], pl:pl + x.shape[2]]
        return grad_x.permute(0, 2, 3, 1).float().to(
            self.act_store_dtype).contiguous()

    def numpy_backprop(self, x, err_output, y=None):
        fwd = self.forward_unit
        x = x.astype(np.float32)
        w = fwd.np_param("weights")
        # conv activations are expressed in the output
        delta = err_output * fwd.activation.np_derivative(y, None)
        k = delta.shape[-1]
        delta2d = delta.reshape(-1, k)
        cols = fwd.im2col(x)
        grad_w = (cols.reshape(-1, cols.shape[-1]).T @ delta2d).reshape(
            w.shape)
        err_input = None
        if self.need_err_input:
            err_cols = (delta2d @ w.reshape(-1, k).T).reshape(cols.shape)
            err_input = col2im(err_cols, x.shape, fwd.ky, fwd.kx,
                               *fwd.sliding, fwd.padding)
        self.numpy_apply_weights(grad_w)
        if fwd.include_bias:
            self.numpy_apply_bias(delta2d.sum(axis=0))
        return err_input


class GDTanhConv(GradientDescentConv):
    MATCHES = (ConvTanh,)


class GDRELUConv(GradientDescentConv):
    MATCHES = (ConvRELU,)


class GDStrictRELUConv(GradientDescentConv):
    MATCHES = (ConvStrictRELU,)


class GDSigmoidConv(GradientDescentConv):
    MATCHES = (ConvSigmoid,)
