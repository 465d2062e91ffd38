"""Sequence-axis reshape units (port of ``znicz_tpu/ops/seq_reshape.py``).

``ToSequence``: (B, d1…dn, C) → (B, Πdᵢ, C), the bridge from a conv
feature map to the sequence stack.  ``LastToken``: (B, T, D) → (B, D),
the last position's features, the bridge from a causal stack to a
position-independent head.  Their backwards are the exact adjoints (a
reshape; the error written into the last position, zeros elsewhere), so
both pairs are weightless.  Outputs and errors are stored at the
activation dtype, as in the reference.  On the numpy oracle they move
numpy arrays the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import Forward, WeightlessGradientUnit


class _Reshape(Forward):
    """A weightless forward that only moves values."""

    EXPORT_PARAMS = ()

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if self.input_shape is not None:
            self.check_input_shape()

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}


class ToSequence(_Reshape):
    """Reshape (B, d1…dn, C) to (B, Πdᵢ, C)."""

    def check_input_shape(self) -> None:
        if len(self.input_shape) < 2:
            raise ValueError(f"to_sequence needs (..., features) samples "
                             f"of rank ≥ 2, got {self.input_shape}")

    @property
    def output_shape(self) -> tuple:
        return (int(np.prod(self.input_shape[:-1])), self.input_shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((x.shape[0],) + self.output_shape).to(
            self.output_store_dtype)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return x.reshape((x.shape[0],) + self.output_shape)


class LastToken(_Reshape):
    """Select the final time position: (B, T, D) → (B, D)."""

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 2:
            raise ValueError(f"last_token needs (time, features) samples, "
                             f"got {self.input_shape}")

    @property
    def output_shape(self) -> tuple:
        return self.input_shape[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, -1].to(self.output_store_dtype)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return x[:, -1]


class GDToSequence(WeightlessGradientUnit):
    """Reshape the error back to the input's shape."""

    MATCHES = (ToSequence,)
    NEEDS_AUTOGRAD = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        return err_output.reshape(x.shape).to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        return err_output.reshape(x.shape) if self.need_err_input else None


class GDLastToken(WeightlessGradientUnit):
    """Adjoint of the last-position select: the error in position T−1,
    zeros elsewhere."""

    MATCHES = (LastToken,)
    NEEDS_AUTOGRAD = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        err = torch.zeros(x.shape, dtype=self.act_store_dtype,
                          device=x.device)
        err[:, -1] = err_output
        return err

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        err = np.zeros(x.shape, np.float32)
        err[:, -1] = err_output
        return err
