"""Cutter: crop a spatial region (port of ``znicz_tpu/ops/cutter.py``).

``Cutter(padding=(left, top, right, bottom))`` removes that many pixels
from each border of an NHWC tensor (an int crops every border by it);
:class:`GDCutter` pads the error back with zeros.  Both are a slice and
a pad of static offsets, with no parameters; the layer type is
``cutter`` (:mod:`znicz_tpu_torch.models.layers`).  On the numpy oracle
they run the reference's numpy path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.nn_units import Forward, WeightlessGradientUnit


class Cutter(Forward):
    """Crop ``padding=(left, top, right, bottom)`` pixels off an NHWC
    batch."""

    EXPORT_PARAMS = ()

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 padding=(0, 0, 0, 0), **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if isinstance(padding, (int, np.integer)):
            padding = (padding,) * 4
        self.padding = tuple(int(p) for p in padding)
        if len(self.padding) != 4:
            raise ValueError("padding must be (left, top, right, bottom)")

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 3:
            raise ValueError(f"{type(self).__name__}: NHWC input expected, "
                             f"got a sample shape {self.input_shape}")
        h, w, _ = self.input_shape
        lf, tp, rt, bt = self.padding
        if h - tp - bt <= 0 or w - lf - rt <= 0:
            raise ValueError(f"{self}: crop {self.padding} leaves nothing "
                             f"of {h}x{w}")

    @property
    def output_shape(self) -> tuple:
        h, w, c = self.input_shape
        lf, tp, rt, bt = self.padding
        return (h - tp - bt, w - lf - rt, c)

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def _crop(self, x):
        lf, tp, rt, bt = self.padding
        h, w = x.shape[1], x.shape[2]
        return x[:, tp:h - bt, lf:w - rt, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._crop(x).to(self.output_store_dtype).contiguous()

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return self._crop(x)


class GDCutter(WeightlessGradientUnit):
    """Zero-pad the error back to the uncropped shape."""

    MATCHES = (Cutter,)
    NEEDS_AUTOGRAD = False

    def _pad_spec(self):
        lf, tp, rt, bt = self.forward_unit.padding
        return ((0, 0), (tp, bt), (lf, rt), (0, 0))

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        lf, tp, rt, bt = self.forward_unit.padding
        return F.pad(err_output, (0, 0, lf, rt, tp, bt)).to(
            self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        return np.pad(err_output, self._pad_spec())
