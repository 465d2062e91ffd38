"""Multi-head attention unit (port of ``znicz_tpu/ops/attention.py``).

``MultiHeadAttention`` maps (B, T, D) → (B, T, D) as the reference's
``xla_forward`` does:

.. code-block:: text

    qkv  = x @ W_qkv + b_qkv          (D, 3·D) packed projection
    q,k,v split → (B, T, H, D/H)
    o    = softmax(q·kᵀ/√dₕ [+causal]) · v     the flash kernel
    y    = concat(o) @ W_out + b_out   (D, D)

In bf16 mode the projections take bf16 operands with f32 results, the
q/k/v slices are stored in bf16 once before the core (the kernel's
operand dtype), and ``y`` is stored in bf16.  The core always goes
through :func:`~znicz_tpu_torch.ops.flash_attention.flash_attention`:
the kernel on the card, its plain version on the CPU.  The q/k/v
slices reach it as strided views of the projection, with no copy.

The ring (sequence-parallel) path, the decode steps and the backward
arrive with later slices.  A bundle trained with ``seq_parallel`` or
``flash_block_k`` serves here all the same: both were layout choices
with identical math.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.ops.flash_attention import flash_attention
from znicz_tpu_torch.ops.nn_units import Forward


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

    def __init__(self, input_shape, compute_dtype: torch.dtype,
                 n_heads: int, causal: bool = False,
                 seq_parallel: bool = False,
                 flash_block_k: int | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if len(self.input_shape) != 2:
            raise ValueError(f"attention expects (time, features) "
                             f"samples, got {self.input_shape}")
        self.n_heads = int(n_heads)
        self.causal = bool(causal)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        qkv = self.mxu_dot(x.float().reshape(b * t, d), self.weights)
        if self.include_bias:
            qkv = qkv + self.bias
        dot_dtype = self.mxu_dtype
        if dot_dtype is not None:
            qkv = qkv.to(dot_dtype)
        q, k, v = split_heads(qkv.reshape(b, t, 3 * d), self.n_heads)
        o = flash_attention(q, k, v, causal=self.causal,
                            dot_dtype=dot_dtype)
        y = self.mxu_dot(o.reshape(b * t, d), self.weights_out)
        if self.include_bias:
            y = y + self.bias_out
        return y.reshape(b, t, d).to(self.output_store_dtype)
