"""Sinusoidal positional encoding (port of
``znicz_tpu/ops/pos_encoding.py``).

``y[b, t, d] = x[b, t, d] + scale·PE[t, d]`` with the interleaved
sin/cos table of :func:`sinusoid_table`.  The table is built on the host
in numpy f32 exactly as the reference builds it, then uploaded once:
``torch.sin`` on the card rounds otherwise.  The add is f32 and the
result is stored at the activation dtype (bf16 in bf16 mode), the one
rounding the reference makes.  Weightless, so the backward is the
identity.

The decode step (``xla_decode_step``) belongs to the decode slice;
:meth:`PositionalEncoding.table_to`, the table to any horizon, is here.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import Forward, WeightlessGradientUnit


def sinusoid_table(t: int, d: int) -> np.ndarray:
    """The (T, D) encoding table: even dims sin, odd dims cos, with the
    10000^(2i/d) wavelength ladder (the reference's, copied)."""
    pos = np.arange(t, dtype=np.float32)[:, None]
    i = np.arange(d, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (i // 2) / d)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


class PositionalEncoding(Forward):
    """Adds the scaled sinusoidal table to a (B, T, D) input."""

    EXPORT_PARAMS = ()

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 scale: float = 1.0, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.scale = float(scale)
        #: the scaled (T, D) table, f32, moved to the input's device on
        #: first use (not a buffer: it is no state of a snapshot)
        self._table: torch.Tensor | None = None
        if self.input_shape is not None:
            self.check_input_shape()

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 2:
            raise ValueError(f"positional encoding expects (time, "
                             f"features) samples, got {self.input_shape}")
        self._table = torch.from_numpy(self.table_to(*self.input_shape))

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def table_to(self, t: int, d: int) -> np.ndarray:
        """The scaled (t, D) table to any horizon (positions are global
        indices, so a decoder extends the training table unchanged)."""
        return self.scale * sinusoid_table(t, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = self._table
        if table.device != x.device:
            table = self._table = table.to(x.device)
        return (x.float() + table).to(self.output_store_dtype)


class GDPositionalEncoding(WeightlessGradientUnit):
    """Backward of an added constant: the error passes through."""

    MATCHES = (PositionalEncoding,)
    NEEDS_AUTOGRAD = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        return err_output.to(self.act_store_dtype)
