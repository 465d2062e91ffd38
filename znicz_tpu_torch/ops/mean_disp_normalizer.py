"""MeanDispNormalizer (port of ``znicz_tpu/ops/mean_disp_normalizer.py``).

``y = (x − mean) · rdisp``: per-feature whitening of the input with
dataset statistics, the mean and the reciprocal dispersion, each of the
sample's shape.  The reference's image loader computes them; until that
loader is ported (ROADMAP A10) the caller sets them (``mean`` and
``rdisp``, arrays or tensors, before ``initialize``).
:class:`GDMeanDispNormalizer` gives ``err_input = err_output · rdisp``.
Elementwise, weightless; on the numpy oracle both run the reference's
numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import (Forward, WeightlessGradientUnit,
                                          as_numpy)


class MeanDispNormalizer(Forward):
    """Whitening with ``mean`` and ``rdisp`` (buffers of the sample's
    shape, f32)."""

    EXPORT_PARAMS = ()

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 mean=None, rdisp=None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.register_buffer("mean", None)
        self.register_buffer("rdisp", None)
        self.mean, self.rdisp = mean, rdisp

    def __setattr__(self, name: str, value) -> None:
        if name in ("mean", "rdisp") and value is not None \
                and not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, dtype=np.float32))
        super().__setattr__(name, value)

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def init_params(self, device) -> None:
        for name in ("mean", "rdisp"):
            if getattr(self, name) is None:
                raise AttributeError(f"{self}: {name} not set")
        self.mean = self.mean.float()
        self.rdisp = self.rdisp.float()
        super().init_params(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ((x.float() - self.mean) * self.rdisp).to(
            self.output_store_dtype)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return ((x.astype(np.float32) - as_numpy(self.mean))
                * as_numpy(self.rdisp))


class GDMeanDispNormalizer(WeightlessGradientUnit):
    """``err_input = err_output · rdisp`` (the transpose of a linear
    unit)."""

    MATCHES = (MeanDispNormalizer,)
    NEEDS_AUTOGRAD = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        return (err_output.float() * self.forward_unit.rdisp).to(
            self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        return err_output * as_numpy(self.forward_unit.rdisp)
