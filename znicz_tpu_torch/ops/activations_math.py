"""Activation functions and their derivatives (port of
``znicz_tpu/ops/activations_math.py``).

The reference's table, in PyTorch:

- ``tanh`` is the scaled LeCun tanh ``y = 1.7159·tanh(0.6666·x)``;
- ``relu`` is the reference's *smooth* RELU ``y = log(1 + exp(x))``
  (softplus);
- ``strict_relu`` is ``max(x, 0)``;
- ``sigmoid`` and ``log`` (``log(x + sqrt(x²+1))``, i.e. asinh)
  complete the set.

Derivatives are expressed in terms of the *output* ``y``, as in the
reference (the backward units read the forward's output); ``log``
needs the input ``x``.  Each is computed in the dtype of its operand,
as the reference computes it, so in bf16 mode the derivative of a
bf16-stored output is bf16, and so are its constants: the reference's
Python constants are weakly typed, so ``(B/A)·(A² − y²)`` on a bf16
``y`` takes B/A and A² rounded to bf16 (:func:`_const`).

Each entry also carries the reference's numpy forms (``np_fwd``,
``np_derivative``), which the numpy oracle runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

_TANH_A = 1.7159
_TANH_B = 0.6666


@dataclass(frozen=True)
class Activation:
    """fwd(x) -> y;  derivative(y, x) -> dy/dx; the same two in numpy."""
    name: str
    fwd: Callable
    derivative: Callable
    np_fwd: Callable
    np_derivative: Callable
    needs_input: bool = False


#: the tanh derivative's constants rounded to bf16 once
_BF16_CONST = {c: float(torch.tensor(c, dtype=torch.bfloat16))
               for c in (_TANH_B / _TANH_A, _TANH_A * _TANH_A)}


def _const(c: float, like: torch.Tensor) -> float:
    """``c`` as an operation on ``like`` takes the reference's weakly
    typed constant: rounded to bf16 when ``like`` is bf16."""
    return _BF16_CONST[c] if like.dtype == torch.bfloat16 else c


def _softplus(x):
    # log(1+exp(x)) stably: max(x,0) + log1p(exp(-|x|))
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _np_softplus(x):
    return np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))


ACTIVATIONS: dict[str, Activation] = {
    "linear": Activation(
        "linear",
        fwd=lambda x: x,
        derivative=lambda y, x: torch.ones_like(y),
        np_fwd=lambda x: x,
        np_derivative=lambda y, x: np.ones_like(y)),
    "tanh": Activation(
        "tanh",
        fwd=lambda x: _TANH_A * torch.tanh(_TANH_B * x),
        # dy/dx = A·B·(1−tanh²) = (B/A)·(A²−y²)
        derivative=lambda y, x: _const(_TANH_B / _TANH_A, y) * (
            _const(_TANH_A * _TANH_A, y) - y * y),
        np_fwd=lambda x: _TANH_A * np.tanh(_TANH_B * x),
        np_derivative=lambda y, x: (_TANH_B / _TANH_A) * (
            _TANH_A * _TANH_A - y * y)),
    "relu": Activation(
        "relu",
        fwd=_softplus,
        # y = log(1+eˣ) ⇒ dy/dx = 1 − e^{−y}
        derivative=lambda y, x: 1.0 - torch.exp(-y),
        np_fwd=_np_softplus,
        np_derivative=lambda y, x: 1.0 - np.exp(-y)),
    "strict_relu": Activation(
        "strict_relu",
        fwd=lambda x: torch.clamp_min(x, 0),
        derivative=lambda y, x: (y > 0).to(y.dtype),
        np_fwd=lambda x: np.maximum(x, 0),
        np_derivative=lambda y, x: (y > 0).astype(y.dtype)),
    "sigmoid": Activation(
        "sigmoid",
        fwd=lambda x: 1.0 / (1.0 + torch.exp(-x)),
        derivative=lambda y, x: y * (1.0 - y),
        np_fwd=lambda x: 1.0 / (1.0 + np.exp(-x)),
        np_derivative=lambda y, x: y * (1.0 - y)),
    "log": Activation(
        "log",
        fwd=lambda x: torch.log(x + torch.sqrt(x * x + 1.0)),
        derivative=lambda y, x: 1.0 / torch.sqrt(x * x + 1.0),
        np_fwd=lambda x: np.log(x + np.sqrt(x * x + 1.0)),
        np_derivative=lambda y, x: 1.0 / np.sqrt(x * x + 1.0),
        needs_input=True),
}


def get(name: str) -> Activation:
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation '{name}' "
            f"(have {sorted(ACTIVATIONS)})") from None
