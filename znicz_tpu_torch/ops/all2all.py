"""Fully-connected forward units (port of ``znicz_tpu/ops/all2all.py``).

``y = x @ W + b`` over the flattened sample, with W stored
(in_features, out_features) as in the reference.  ``All2AllSoftmax``
applies a row softmax over the linear output and also gives the
per-sample argmax ``max_idx`` (int32), as the reference's unit does.
Its probabilities stay f32 in every precision mode.  The products are
plain ``torch.matmul`` calls, as the reference left them to XLA.

Their backward units are in :mod:`znicz_tpu_torch.ops.gd`.  The
activation flavors (tanh, relu, …) and tensor parallelism arrive with
later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import Forward


class All2All(Forward):
    """Linear fully-connected layer."""

    def __init__(self, input_shape, compute_dtype: torch.dtype,
                 output_sample_shape, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if isinstance(output_sample_shape, (int, np.integer)):
            output_sample_shape = (int(output_sample_shape),)
        self.output_sample_shape = tuple(int(n) for n in output_sample_shape)

    @property
    def output_shape(self) -> tuple:
        return self.output_sample_shape

    def param_shapes(self) -> dict[str, tuple]:
        n_in = int(np.prod(self.input_shape))
        n_out = int(np.prod(self.output_sample_shape))
        shapes = {"weights": (n_in, n_out)}
        if self.include_bias:
            shapes["bias"] = (n_out,)
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        n_in = int(np.prod(self.input_shape))
        shapes = self.param_shapes()
        params = {"weights": self.fill_array(
            shapes["weights"], self.weights_filling, self.weights_stddev,
            fan_in=n_in)}
        if self.include_bias:
            params["bias"] = self.fill_array(
                shapes["bias"], self.bias_filling, self.bias_stddev,
                fan_in=n_in)
        return params

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mxu_dot(x.reshape(x.shape[0], -1), self.weights)
        return y + self.bias if self.include_bias else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._logits(x)
        return y.reshape((x.shape[0],) + self.output_sample_shape).to(
            self.output_store_dtype)


class All2AllSoftmax(All2All):
    """Softmax output layer; :meth:`classify` also gives the argmax."""

    @property
    def output_store_dtype(self) -> torch.dtype:
        # probabilities stay f32: tiny, and read as scores by callers
        return torch.float32

    def classify(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(probabilities f32, max_idx int32)`` for a batch."""
        logits = self._logits(x)
        m = logits.amax(dim=1, keepdim=True)
        e = torch.exp(logits - m)
        probs = e / e.sum(dim=1, keepdim=True)
        return probs, torch.argmax(logits, dim=1).to(torch.int32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classify(x)[0]
