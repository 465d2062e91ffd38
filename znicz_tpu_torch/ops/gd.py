"""Gradient-descent units of the fully-connected family (port of
``znicz_tpu/ops/gd.py``).

Math (weights stored ``(in, out)``), the reference's explicit formulas:

.. code-block:: text

    δ         = err_output · act'(y)   in the storage dtype of err and y
    err_input = mxu_dot(δ, Wᵀ)        stored in the activation dtype
    dL/dW     = mxu_dot(xᵀ, δ)
    dL/db     = Σ_batch δ             f32

then the shared update of
:class:`~znicz_tpu_torch.ops.nn_units.GradientDescentBase`.  ``act'`` is
expressed in the forward's output ``y``, which the workflow hands each
backward unit.  In bf16 mode ``mxu_dot`` rounds δ to bf16 *before* each
product; autograd through the forward would instead round the
product's result, so these units write the formulas out rather than
differentiate.  The evaluator emits ``err_output`` already divided by
the number of valid samples.

``GDSoftmax`` is the linear case: it takes ``err_output`` as it comes,
the softmax + cross-entropy derivative (``p − t``) that
``EvaluatorSoftmax`` folds into it, or ``EvaluatorMSE``'s error at the
probabilities under the MSE loss, as the reference's linear
``GDSoftmax`` does.  On the numpy oracle each unit runs the reference's
numpy path (:meth:`GradientDescent.numpy_backprop`).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.all2all import (All2All, All2AllRELU,
                                         All2AllSigmoid, All2AllSoftmax,
                                         All2AllStrictRELU, All2AllTanh)
from znicz_tpu_torch.ops.nn_units import GradientDescentBase


class GradientDescent(GradientDescentBase):
    """Backward of the linear ``All2All``."""

    MATCHES = (All2All,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        batch = x.shape[0]
        x2d = x.reshape(batch, -1)
        delta = err_output.reshape(batch, -1)
        act = fwd.activation
        if act.name != "linear":
            delta = delta * act.derivative(
                y.reshape(batch, -1),
                x2d if act.needs_input else None)
        err_input = None
        if self.need_err_input:
            # reads W before this unit's own update below
            err_input = fwd.fold_err_input(
                fwd.mxu_dot(delta, fwd.weights.t())).reshape(
                x.shape).to(self.act_store_dtype)
        self.apply_weights(fwd.mxu_dot(x2d.t(), delta))
        if fwd.include_bias:
            self.apply_bias(delta.float().sum(dim=0))
        return err_input

    def numpy_backprop(self, x, err_output, y=None):
        fwd = self.forward_unit
        x = x.astype(np.float32)
        batch = x.shape[0]
        x2d = x.reshape(batch, -1)
        act = fwd.activation
        delta = err_output.reshape(batch, -1) * act.np_derivative(
            y.reshape(batch, -1), x2d if act.needs_input else None)
        err_input = None
        if self.need_err_input:
            err_input = (delta @ fwd.np_param("weights").T).reshape(x.shape)
        self.numpy_apply_weights(x2d.T @ delta)
        if fwd.include_bias:
            self.numpy_apply_bias(delta.sum(axis=0))
        return err_input


class GDTanh(GradientDescent):
    MATCHES = (All2AllTanh,)


class GDRELU(GradientDescent):
    MATCHES = (All2AllRELU,)


class GDStrictRELU(GradientDescent):
    MATCHES = (All2AllStrictRELU,)


class GDSigmoid(GradientDescent):
    MATCHES = (All2AllSigmoid,)


class GDSoftmax(GradientDescent):
    """Linear backward: the evaluator already folded the softmax +
    cross-entropy derivative into ``err_output``."""

    MATCHES = (All2AllSoftmax,)
