"""Standalone activation units (port of ``znicz_tpu/ops/activation.py``):
an activation that is not fused into an ``All2All`` or a ``Conv``.

``ForwardTanh``, ``ForwardRELU``, ``ForwardStrictRELU``,
``ForwardSigmoid`` and ``ForwardLog`` apply the functions of
:mod:`~znicz_tpu_torch.ops.activations_math` element by element
(``y = act(x)``, the output of the input's shape), and their
``Backward*`` units give ``err_input = err_output ⊙ act'(y)`` (``log``
reads ``x``).  ``ForwardMul`` scales by a constant ``factor`` and
``BackwardMul`` scales the error by it.  Both directions compute in the
dtype of their operands, as the reference's region does, and store in
the activation dtype.  On the numpy oracle they run the reference's
numpy path.

They are weightless: a backward takes no learning rate, and no
learning-rate schedule claims it.  The layer types are
``activation_tanh``, ``activation_relu``, ``activation_str``,
``activation_sigmoid``, ``activation_log`` and ``activation_mul``
(:mod:`znicz_tpu_torch.models.layers`).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops import activations_math
from znicz_tpu_torch.ops.nn_units import Forward, WeightlessGradientUnit


class ActivationForward(Forward):
    """Weightless elementwise forward ``y = act(x)``."""

    ACTIVATION = "linear"
    EXPORT_PARAMS = ()

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.activation = activations_math.get(self.ACTIVATION)

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.activation.fwd(x).to(self.output_store_dtype)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return self.activation.np_fwd(x.astype(np.float32))


class ActivationBackward(WeightlessGradientUnit):
    """Weightless backward ``err_input = err_output ⊙ act'``."""

    NEEDS_AUTOGRAD = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        act = self.forward_unit.activation
        return (err_output * act.derivative(
            y, x if act.needs_input else None)).to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        act = self.forward_unit.activation
        return err_output * act.np_derivative(
            y, x if act.needs_input else None)


class ForwardTanh(ActivationForward):
    ACTIVATION = "tanh"


class BackwardTanh(ActivationBackward):
    MATCHES = (ForwardTanh,)


class ForwardRELU(ActivationForward):
    ACTIVATION = "relu"


class BackwardRELU(ActivationBackward):
    MATCHES = (ForwardRELU,)


class ForwardStrictRELU(ActivationForward):
    ACTIVATION = "strict_relu"


class BackwardStrictRELU(ActivationBackward):
    MATCHES = (ForwardStrictRELU,)


class ForwardSigmoid(ActivationForward):
    ACTIVATION = "sigmoid"


class BackwardSigmoid(ActivationBackward):
    MATCHES = (ForwardSigmoid,)


class ForwardLog(ActivationForward):
    ACTIVATION = "log"


class BackwardLog(ActivationBackward):
    MATCHES = (ForwardLog,)


class ForwardMul(ActivationForward):
    """Scale by a constant ``factor``."""

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 factor: float = 1.0, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.factor = float(factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.factor).to(self.output_store_dtype)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return x * self.factor


class BackwardMul(WeightlessGradientUnit):
    """``err_input = err_output · factor``."""

    MATCHES = (ForwardMul,)
    NEEDS_AUTOGRAD = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        return (err_output * self.forward_unit.factor).to(
            self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        return err_output * self.forward_unit.factor
