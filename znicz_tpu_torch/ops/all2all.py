"""Fully-connected forward units (port of ``znicz_tpu/ops/all2all.py``).

``y = act(x @ W + b)`` over the flattened sample, with W stored
(in_features, out_features) as in the reference, in the activation
flavors of :mod:`~znicz_tpu_torch.ops.activations_math` (linear, tanh,
smooth relu, strict relu, sigmoid).  ``All2AllSoftmax`` applies a row
softmax over the linear output and also gives the per-sample argmax
``max_idx`` (int32), as the reference's unit does, both through the
softmax-argmax kernel
(:func:`~znicz_tpu_torch.ops.fused_kernels.softmax_argmax`, its plain
version on the CPU).  Its probabilities stay f32 in every precision
mode.  The products are plain ``torch.matmul`` calls, as the reference
left them to XLA.  On the numpy oracle each runs the reference's numpy
path (:meth:`All2All.numpy_forward`).

Their backward units are in :mod:`znicz_tpu_torch.ops.gd`.  Tensor
parallelism arrives with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops import activations_math
from znicz_tpu_torch.ops.fused_kernels import softmax_argmax
from znicz_tpu_torch.ops.nn_units import Forward, as_numpy, stored_f32


class All2All(Forward):
    """Linear fully-connected layer."""

    ACTIVATION = "linear"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, output_sample_shape=1, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if isinstance(output_sample_shape, (int, np.integer)):
            output_sample_shape = (int(output_sample_shape),)
        self.output_sample_shape = tuple(int(n) for n in output_sample_shape)
        self.activation = activations_math.get(self.ACTIVATION)

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
        y = self.activation.fwd(self._logits(x))
        return y.reshape((x.shape[0],) + self.output_sample_shape).to(
            self.output_store_dtype)

    def _np_logits(self, x: np.ndarray) -> np.ndarray:
        y = x.astype(np.float32).reshape(x.shape[0], -1) \
            @ self.np_param("weights")
        return y + self.np_param("bias") if self.include_bias else y

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        y = self.activation.np_fwd(self._np_logits(x))
        return y.reshape((x.shape[0],) + self.output_sample_shape)


class All2AllTanh(All2All):
    """Scaled-tanh flavor."""
    ACTIVATION = "tanh"


class All2AllRELU(All2All):
    """Smooth-RELU (softplus) flavor."""
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    """max(x, 0) flavor."""
    ACTIVATION = "strict_relu"


class All2AllSigmoid(All2All):
    """Sigmoid flavor."""
    ACTIVATION = "sigmoid"


class All2AllSoftmax(All2All):
    """Softmax output layer; :meth:`classify` also gives the argmax."""

    @property
    def output_store_dtype(self) -> torch.dtype:
        # probabilities stay f32: tiny, and read as scores by callers
        return torch.float32

    def classify(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(probabilities f32, max_idx int32)`` for a batch, from the
        f32 logits through the softmax-argmax kernel."""
        return softmax_argmax(self._logits(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classify(x)[0]

    def device_run(self) -> None:
        self.output, self.max_idx = self.classify(self.input)

    def numpy_run(self) -> None:
        logits = self._np_logits(as_numpy(self.input))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.output = stored_f32(e / e.sum(axis=1, keepdims=True))
        self.max_idx = np.argmax(logits, axis=1).astype(np.int32)
