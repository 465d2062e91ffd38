"""Forward and gradient-descent unit bases (counterpart of
``znicz_tpu/ops/nn_units.py`` and the precision rules of
``znicz_tpu/accelerated_units.py``).

A forward unit here is an ``nn.Module`` over a batch of samples of one
input shape, in one compute dtype.  Its parameters carry the bundle's
names (``weights``, ``bias``, …) and stay float32 in every precision
mode, as in the reference.  They come either from a bundle
(:meth:`Forward.load_params`) or from the reference's initial fills
(:meth:`Forward.init_params`, drawn from :mod:`znicz_tpu_torch.utils.prng`
in the reference's order, so one seed gives the same weights in both
packages).

Two precision rules carry over from the reference's XLA path:

- :meth:`Forward.mxu_dot` — in bf16 mode the product's operands are
  rounded to bf16 and the result is f32 (the reference's ``jnp.dot``
  with ``preferred_element_type=float32``).  Here that is an f32
  product of bf16-rounded operands; with TF32 off
  (:mod:`znicz_tpu_torch.backends`) it is exact up to summation order.
  Autograd through it rounds the cotangent of each operand to bf16,
  where ``jax.vjp`` of the reference's ``mxu_dot`` does.
- :attr:`Forward.act_store_dtype` — activations and errors between
  layers are stored in bf16 in bf16 mode and in f32 otherwise.

:class:`GradientDescentBase` is the reference's update rule, cut to what
the training paths run (learning rates, L1/L2 decay, momentum,
gradient-norm clipping); ZeRO-1, the anomaly guard, the SDC fingerprint,
microbatch accumulation and fp8 belong to later slices.  Momentum is
stored in bf16 in bf16 mode with its math in f32, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from znicz_tpu_torch import backends  # noqa: F401 — no TF32 in f32 products
from znicz_tpu_torch.utils import prng


def precision_dtypes(compute_dtype: torch.dtype
                     ) -> tuple[torch.dtype | None, torch.dtype]:
    """``(product operand dtype or None, storage dtype)`` of activations,
    errors and momentum in one precision mode."""
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16, torch.bfloat16
    return None, torch.float32


class Forward(nn.Module):
    """Base forward unit over a batch of samples of ``input_shape``."""

    #: parameter attributes an exported bundle carries for this unit
    EXPORT_PARAMS: tuple = ("weights", "bias")
    #: manifest config keys that only shape the random initial fill
    INIT_ONLY = frozenset(("weights_filling", "weights_stddev",
                           "bias_filling", "bias_stddev"))
    #: the initial weight fill when the config names none
    WEIGHTS_FILLING = "uniform"

    def __init__(self, input_shape, compute_dtype: torch.dtype,
                 include_bias: bool = True, **init_config) -> None:
        unknown = set(init_config) - self.INIT_ONLY
        if unknown:
            raise TypeError(f"{type(self).__name__}: unsupported config "
                            f"{sorted(unknown)}")
        super().__init__()
        self.input_shape = tuple(int(n) for n in input_shape)
        self.compute_dtype = compute_dtype
        self.include_bias = bool(include_bias)
        self.weights_filling = init_config.get("weights_filling",
                                               self.WEIGHTS_FILLING)
        self.weights_stddev = init_config.get("weights_stddev")
        self.bias_filling = init_config.get("bias_filling", "uniform")
        self.bias_stddev = init_config.get("bias_stddev")

    # -- geometry and parameters ------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Shape of every parameter this unit needs, by attribute."""
        raise NotImplementedError

    @property
    def output_shape(self) -> tuple:
        """Per-sample output shape."""
        return self.input_shape

    def load_params(self, arrays: dict[str, torch.Tensor]) -> None:
        """Adopt a parameter set (``attr → tensor``) as float32 copies.
        A missing or mis-shaped parameter raises: serving a random or
        truncated substitute would be silently wrong."""
        for attr, shape in self.param_shapes().items():
            value = arrays.get(attr)
            if value is None:
                raise ValueError(f"{type(self).__name__}: parameter "
                                 f"'{attr}' missing from the bundle")
            if tuple(value.shape) != tuple(shape):
                raise ValueError(
                    f"{type(self).__name__} {attr}: bundle shape "
                    f"{tuple(value.shape)} != expected {tuple(shape)}")
            setattr(self, attr, nn.Parameter(
                value.detach().to(torch.float32).clone(),
                requires_grad=False))

    def fill_array(self, shape, filling: str, stddev: float | None,
                   fan_in: int) -> np.ndarray:
        """One initial fill from the default generator (the reference's
        ``Forward.fill_array``, copied)."""
        gen = prng.get()
        if stddev is None:
            stddev = 1.0 / max(1.0, np.sqrt(fan_in))
        if filling == "uniform":
            return gen.fill_uniform(shape, -stddev, stddev,
                                    dtype=np.float32)
        if filling == "gaussian":
            return gen.fill_normal(shape, 0.0, stddev, dtype=np.float32)
        if filling == "constant":
            return np.full(shape, stddev, dtype=np.float32)
        if filling == "he":
            return gen.fill_normal(shape, 0.0,
                                   float(np.sqrt(2.0 / max(1, fan_in))),
                                   dtype=np.float32)
        if filling == "xavier":
            return gen.fill_normal(shape, 0.0,
                                   float(np.sqrt(1.0 / max(1, fan_in))),
                                   dtype=np.float32)
        raise ValueError(f"unknown filling '{filling}'")

    def initial_params(self) -> dict[str, np.ndarray]:
        """The unit's initial parameters, drawn in the order the
        reference's ``initialize`` draws them."""
        raise NotImplementedError

    def init_params(self, device) -> None:
        """Fill the parameters as the reference does and place them on
        ``device``."""
        self.load_params({k: torch.from_numpy(v)
                          for k, v in self.initial_params().items()})
        self.to(device)

    # -- precision --------------------------------------------------------
    @property
    def mxu_dtype(self) -> torch.dtype | None:
        """Product operand dtype: bf16 in bf16 mode, else None (full
        f32 products)."""
        return precision_dtypes(self.compute_dtype)[0]

    @property
    def act_store_dtype(self) -> torch.dtype:
        """Storage dtype of activations: bf16 in bf16 mode, else f32."""
        return precision_dtypes(self.compute_dtype)[1]

    @property
    def output_store_dtype(self) -> torch.dtype:
        return self.act_store_dtype

    def mxu_dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with f32 result; operands rounded to bf16 first in
        bf16 mode."""
        dt = self.mxu_dtype
        if dt is not None:
            a, b = a.to(dt), b.to(dt)
        return torch.matmul(a.float(), b.float())


#: forward class → its backward class, filled from each backward
#: class's ``MATCHES`` (the reference's ``MatchingObject`` registry)
_GD_FOR_FORWARD: dict[type, type] = {}


def gd_for(forward_cls: type) -> type:
    """The backward class paired with ``forward_cls`` (walks the MRO, so
    a subclass inherits its parent's pairing unless it has its own)."""
    for klass in forward_cls.__mro__:
        gd = _GD_FOR_FORWARD.get(klass)
        if gd is not None:
            return gd
    raise KeyError(f"no gradient unit registered for {forward_cls.__name__}")


class GradientDescentBase(nn.Module):
    """Base backward unit: the reference's update rule for each
    parameter tensor of its forward unit.

    .. code-block:: text

        ĝ   = dL/dW · min(1, gradient_clip / ‖dL/dW‖₂)      (clip > 0)
        g   = ĝ + weights_decay·((1−l1_vs_l2)·W + ½·l1_vs_l2·sign(W))
        acc = gradient_moment·acc − learning_rate·g
        W  += acc

    A subclass's :meth:`run` computes ``err_input`` (when the previous
    unit wants it) and its parameter gradients from the weights as they
    were before this step, then updates the parameters in place through
    :meth:`apply_param`.
    """

    #: forward classes this backward unit belongs to
    MATCHES: tuple = ()

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        for fwd_cls in cls.__dict__.get("MATCHES", ()):
            _GD_FOR_FORWARD[fwd_cls] = cls

    def __init__(self, forward_unit: Forward, learning_rate: float = 0.01,
                 learning_rate_bias: float | None = None,
                 weights_decay: float = 0.0,
                 weights_decay_bias: float = 0.0,
                 l1_vs_l2: float = 0.0,
                 gradient_moment: float = 0.0,
                 gradient_moment_bias: float | None = None,
                 gradient_clip: float = 0.0,
                 need_err_input: bool = True) -> None:
        super().__init__()
        # a plain attribute, not a submodule: the forward owns its
        # parameters
        self.__dict__["forward_unit"] = forward_unit
        self.learning_rate = learning_rate
        self.learning_rate_bias = (learning_rate if learning_rate_bias is None
                                   else learning_rate_bias)
        self.weights_decay = weights_decay
        self.weights_decay_bias = weights_decay_bias
        self.l1_vs_l2 = l1_vs_l2
        self.gradient_moment = gradient_moment
        self.gradient_moment_bias = (gradient_moment
                                     if gradient_moment_bias is None
                                     else gradient_moment_bias)
        self.gradient_clip = gradient_clip
        self.need_err_input = need_err_input
        self.alloc_accumulator("accumulated_gradient_weights", "weights",
                               self.gradient_moment)
        self.alloc_accumulator("accumulated_gradient_bias", "bias",
                               self.gradient_moment_bias)

    @property
    def opt_state_dtype(self) -> torch.dtype:
        """Storage dtype of the momentum accumulators: bf16 in bf16
        mode (the math stays f32), else f32."""
        return precision_dtypes(self.forward_unit.compute_dtype)[1]

    @property
    def act_store_dtype(self) -> torch.dtype:
        return self.forward_unit.act_store_dtype

    def alloc_accumulator(self, name: str, param: str,
                          moment: float) -> None:
        """A zero momentum buffer ``name`` for the forward's ``param``
        (None when the parameter or the moment is absent)."""
        value = getattr(self.forward_unit, param, None)
        self.register_buffer(name, torch.zeros(
            value.shape, dtype=self.opt_state_dtype, device=value.device)
            if moment and value is not None else None)

    def run(self, x: torch.Tensor, err_output: torch.Tensor,
            y: torch.Tensor | None = None) -> torch.Tensor | None:
        """One backward step from the forward's input ``x``, the error
        at its output and the forward's output ``y`` of this step;
        returns ``err_input`` in the activation storage dtype, or None
        when no unit before wants it."""
        raise NotImplementedError

    # -- the update rule --------------------------------------------------
    def _regularized(self, grad, weights, decay: float):
        if not decay:
            return grad
        l1 = self.l1_vs_l2
        reg = (1.0 - l1) * weights
        if l1:
            reg = reg + 0.5 * l1 * torch.sign(weights)
        return grad + decay * reg

    def _clipped(self, grad):
        clip = self.gradient_clip
        if not clip:
            return grad
        norm = torch.sqrt(torch.sum(grad * grad))
        return grad * torch.clamp(clip / torch.clamp(norm, min=1e-30),
                                  max=1.0)

    @torch.no_grad()
    def apply_param(self, param: torch.Tensor, grad: torch.Tensor,
                    acc: torch.Tensor | None, decay: float, lr: float,
                    moment: float) -> None:
        """Update one parameter tensor in place from its f32 gradient."""
        g = self._regularized(self._clipped(grad.float()), param, decay)
        if moment:
            # f32 math whatever the accumulator stores; the weight takes
            # the f32 step, the store rounds to opt_state_dtype
            step = moment * acc.float() - lr * g
            acc.copy_(step)
            param.add_(step)
        else:
            param.sub_(lr * g)

    def apply_weights(self, grad: torch.Tensor, param: str = "weights",
                      acc: str = "accumulated_gradient_weights") -> None:
        self.apply_param(getattr(self.forward_unit, param), grad,
                         getattr(self, acc), self.weights_decay,
                         self.learning_rate, self.gradient_moment)

    def apply_bias(self, grad: torch.Tensor, param: str = "bias",
                   acc: str = "accumulated_gradient_bias") -> None:
        self.apply_param(getattr(self.forward_unit, param), grad,
                         getattr(self, acc), self.weights_decay_bias,
                         self.learning_rate_bias, self.gradient_moment_bias)
