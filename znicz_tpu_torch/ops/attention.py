"""Multi-head attention unit and its backward (port of
``znicz_tpu/ops/attention.py``).

``MultiHeadAttention`` maps (B, T, D) → (B, T, D) as the reference's
``xla_forward`` does:

.. code-block:: text

    qkv  = x @ W_qkv + b_qkv          (D, 3·D) packed projection
    q,k,v split → (B, T, H, D/H)
    o    = softmax(q·kᵀ/√dₕ [+causal]) · v     the flash kernel
    y    = concat(o) @ W_out + b_out   (D, D)

In bf16 mode the projections take bf16 operands with f32 results, the
q/k/v slices are stored in bf16 once before the core (the kernel's
operand dtype), and ``y`` is stored in bf16.  The core is
:func:`~znicz_tpu_torch.ops.flash_attention.attention_core`, routed as
the reference routes it: the flash kernels (bf16 or f32, on the card;
their plain versions on the CPU) when the head dim is a multiple of 8,
else the plain attention core on every device.  The q/k/v slices reach
it as strided views of the projection, with no copy.

Backward: ``GDMultiHeadAttention`` takes ``torch.autograd.grad`` of the
output the forward kept on the train step, with respect to ``(x,
W_qkv, b_qkv, W_out, b_out)`` — the counterpart of the reference's
stashed ``jax.vjp`` pullback, so the forward never runs twice.  The
core's gradient is the flash backward kernels (through
:class:`~znicz_tpu_torch.ops.flash_attention.FlashHop`), or autograd of
the plain core where the head dim routes there.  Autograd
rounds each cotangent to bf16 where the forward cast to bf16, as
``jax.vjp`` does at the same casts, so the forward's chain of casts
here must stay the reference's.

The ring (sequence-parallel) path and the decode steps arrive with
later slices.  A bundle trained with ``seq_parallel`` or
``flash_block_k`` serves here all the same: both were layout choices
with identical math.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.flash_attention import attention_core
from znicz_tpu_torch.ops.nn_units import Forward, GradientDescentBase


def split_heads(qkv: torch.Tensor, n_heads: int):
    """(B, T, 3D) → three (B, T, H, D/H) views (slicing and reshape
    only)."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    shape = (b, t, n_heads, d // n_heads)
    return (qkv[..., :d].view(shape), qkv[..., d:2 * d].view(shape),
            qkv[..., 2 * d:].view(shape))


class MultiHeadAttention(Forward):
    """Weighted multi-head self-attention layer."""

    EXPORT_PARAMS = ("weights", "bias", "weights_out", "bias_out")
    #: fan-scaled initial fill, as the reference's attention defaults to
    WEIGHTS_FILLING = "xavier"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, n_heads: int = 1, causal: bool = False,
                 seq_parallel: bool = False,
                 flash_block_k: int | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.n_heads = int(n_heads)
        self.causal = bool(causal)
        #: set by the backward unit: keep the autograd graph of a call
        #: made with gradients enabled, and whether ``x``'s gradient is
        #: wanted too
        self.keep_graph = False
        self.input_grad = False
        #: ``(x, f32 output)`` of the last call that kept its graph
        self.stash: tuple | None = None
        if self.input_shape is not None:
            self.check_input_shape()

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 2:
            raise ValueError(f"attention expects (time, features) "
                             f"samples, got {self.input_shape}")
        d = self.input_shape[1]
        if d % self.n_heads:
            raise ValueError(f"features {d} not divisible by "
                             f"{self.n_heads} heads")

    def param_shapes(self) -> dict[str, tuple]:
        d = self.input_shape[1]
        shapes = {"weights": (d, 3 * d), "weights_out": (d, d)}
        if self.include_bias:
            shapes.update(bias=(3 * d,), bias_out=(d,))
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        d = self.input_shape[1]
        params = {
            "weights": self.fill_array((d, 3 * d), self.weights_filling,
                                       self.weights_stddev, fan_in=d),
            "weights_out": self.fill_array((d, d), self.weights_filling,
                                           self.weights_stddev, fan_in=d)}
        if self.include_bias:
            params.update(bias=np.zeros(3 * d, np.float32),
                          bias_out=np.zeros(d, np.float32))
        return params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.keep_graph and torch.is_grad_enabled()):
            return self.core(x).to(self.output_store_dtype)
        x = x.detach().requires_grad_(self.input_grad)
        y = self.core(x)
        self.stash = (x, y)
        return y.detach().to(self.output_store_dtype)

    def core(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 output (B, T, D) before its storage cast — what the
        reference's ``xla_forward`` returns and differentiates."""
        b, t, d = x.shape
        qkv = self.mxu_dot(x.float().reshape(b * t, d), self.weights)
        if self.include_bias:
            qkv = qkv + self.bias
        dot_dtype = self.mxu_dtype
        if dot_dtype is not None:
            qkv = qkv.to(dot_dtype)
        q, k, v = split_heads(qkv.reshape(b, t, 3 * d), self.n_heads)
        o = attention_core(q, k, v, causal=self.causal, dot_dtype=dot_dtype)
        y = self.mxu_dot(o.reshape(b * t, d), self.weights_out)
        if self.include_bias:
            y = y + self.bias_out
        return y.reshape(b, t, d)


class GDMultiHeadAttention(GradientDescentBase):
    """Attention backward: autograd of the output the forward kept,
    then the base update for both parameter pairs."""

    MATCHES = (MultiHeadAttention,)

    def bind_forward(self) -> None:
        super().bind_forward()
        forward_unit = self.forward_unit
        self.alloc_accumulator("accumulated_gradient_weights_out",
                               "weights_out", self.gradient_moment)
        self.alloc_accumulator("accumulated_gradient_bias_out",
                               "bias_out", self.gradient_moment_bias)
        for attr in forward_unit.param_shapes():
            getattr(forward_unit, attr).requires_grad_(True)
        forward_unit.keep_graph = True
        forward_unit.input_grad = self.need_err_input

    def micro_accum_params(self) -> list[tuple[str, str]]:
        # the output projection's pair accumulates too
        return super().micro_accum_params() + [("wo", "weights_out"),
                                               ("bo", "bias_out")]

    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        stash, fwd.stash = fwd.stash, None  # the graph is used once
        if stash is None:
            raise RuntimeError(f"{type(fwd).__name__}: no forward graph "
                               f"kept for this step (run the forward "
                               f"with gradients enabled first)")
        x_leaf, y = stash
        names = list(fwd.param_shapes())
        inputs = [getattr(fwd, n) for n in names]
        if self.need_err_input:
            inputs.append(x_leaf)
        # every gradient is taken before any parameter changes below
        grads = dict(zip(names + ["x"], torch.autograd.grad(
            y, inputs, grad_outputs=err_output.float())))
        self.apply_weights(grads["weights"])
        self.apply_weights(grads["weights_out"], "weights_out",
                           "accumulated_gradient_weights_out")
        if fwd.include_bias:
            self.apply_bias(grads["bias"])
            self.apply_bias(grads["bias_out"], "bias_out",
                            "accumulated_gradient_bias_out")
        if not self.need_err_input:
            return None
        return grads["x"].to(self.act_store_dtype)
