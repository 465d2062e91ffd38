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

:meth:`All2All.head` is the same layer as a pure function of explicit
``(x, w, b)``, through the same :meth:`mxu_dot` (the reference's
``_forward`` and ``_logits``): a decoder's head layers, whose weights
it holds itself.

Their backward units are in :mod:`znicz_tpu_torch.ops.gd`.

Tensor parallelism (``model_parallel``, the reference's Megatron pair)
on a device whose mesh has a ``model`` axis of 2 or more: every process
draws the whole initial fill from the shared seed and keeps its block
of it (the placement, through the workflow's partition table:
:func:`~znicz_tpu_torch.parallel.partition.model_sharded`).

- ``"column"``: the weights and the bias split ``n_out``; the output is
  this process's block of the features.  The backward sums ``err_input``
  over ``model`` (:meth:`All2All.fold_err_input`).
- ``"row"``: the weights split ``n_in``, the input is the previous
  column layer's block of features; the partial product is summed over
  ``model``, then the bias is added and the activation applied.

A width that the axis does not divide raises, as in the reference.
Without a model axis the option changes nothing, so a bundle trained
that way serves on one device (the export gathers the blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops import activations_math
from znicz_tpu_torch.ops.fused_kernels import softmax_argmax
from znicz_tpu_torch.ops.nn_units import Forward, as_numpy, stored_f32
from znicz_tpu_torch.parallel import partition
from znicz_tpu_torch.parallel.axis import MODEL_AXIS, all_reduce


class All2All(Forward):
    """Linear fully-connected layer."""

    ACTIVATION = "linear"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, output_sample_shape=1,
                 model_parallel: str | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if isinstance(output_sample_shape, (int, np.integer)):
            output_sample_shape = (int(output_sample_shape),)
        self.output_sample_shape = tuple(int(n) for n in output_sample_shape)
        self.activation = activations_math.get(self.ACTIVATION)
        if model_parallel not in (None, "column", "row"):
            raise ValueError(f"model_parallel '{model_parallel}' (column, "
                             f"row or None)")
        self.model_parallel = model_parallel

    @property
    def model_split(self) -> str | None:
        """``"column"`` or ``"row"`` when this process holds a block of
        the weights (a model axis of 2 or more), else None."""
        if self.model_parallel is None or self.device is None \
                or self.device.axis_size(MODEL_AXIS) < 2:
            return None
        return self.model_parallel

    def init_params(self, device) -> None:
        """The whole initial fill (the same draws on every process), then
        this process's block of it under tensor parallelism."""
        super().init_params(device)
        split = self.model_split
        if split is None:
            return
        n = self.device.axis_size(MODEL_AXIS)
        shapes = self.param_shapes()
        n_in, n_out = shapes["weights"]
        width = n_out if split == "column" else n_in
        if width % n:
            raise ValueError(
                f"{self.name}: {split}-parallel width {width} not "
                f"divisible by the model axis ({n})")
        names = ["weights"] + (["bias"] if split == "column"
                               and self.include_bias else [])
        for name in names:
            dim = (1 if name == "weights" else 0) if split == "column" \
                else 0
            self.place(name, partition.model_sharded(dim), shapes[name])
            full = getattr(self, name).detach()
            block = partition.local_slice(full, self.placements[name],
                                          self.device.mesh)
            setattr(self, name, torch.nn.Parameter(block, requires_grad=False))

    @property
    def output_feature_block(self) -> bool:
        """A column layer's output is this process's block of the
        features."""
        return self.model_split == "column"

    def fold_err_input(self, err: torch.Tensor) -> torch.Tensor:
        """A column layer's ``err_input`` is a partial sum over its block
        of features: summed over ``model``.  Otherwise unchanged."""
        if self.model_split != "column":
            return err
        return all_reduce(err, self.device.group(MODEL_AXIS))

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
        if self.model_split == "row":
            # the partial products of the blocks of n_in
            y = all_reduce(y, self.device.group(MODEL_AXIS))
        return y + self.bias if self.include_bias else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.activation.fwd(self._logits(x))
        shape = (self.output_sample_shape if self.model_split != "column"
                 else (-1,))
        return y.reshape((x.shape[0],) + shape).to(self.output_store_dtype)

    def head(self, x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor | None, final: bool = False) -> torch.Tensor:
        """The layer on (B, ...) features with the weights ``w`` and
        ``b`` (None: no bias), f32: the activated output, or with
        ``final`` the raw logits (a softmax head's argmax is its
        logits')."""
        y = self.mxu_dot(x.reshape(x.shape[0], -1), w)
        if b is not None:
            y = y + b
        if final:
            return y
        return self.activation.fwd(y).reshape(
            (x.shape[0],) + self.output_sample_shape)

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
