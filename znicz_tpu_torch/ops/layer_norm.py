"""Layer normalization unit (port of ``znicz_tpu/ops/layer_norm.py``).

``y = γ · (x − μ) / √(σ² + ε) + β`` over the last (feature) axis, with
γ/β in the bundle's ``weights``/``bias`` (shape (D,), f32).  The
statistics are f32 even under bf16 activation storage; the output is
stored at the activation dtype.  The computation is the fused kernel
:func:`~znicz_tpu_torch.ops.fused_kernels.layer_norm_forward` on the
card and its plain version on the CPU.  The backward arrives with the
training slice.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.ops.fused_kernels import layer_norm_forward
from znicz_tpu_torch.ops.nn_units import Forward


class LayerNorm(Forward):
    """Per-position feature normalization with learned scale/shift."""

    def __init__(self, input_shape, compute_dtype: torch.dtype,
                 eps: float = 1e-5, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.eps = float(eps)

    def param_shapes(self) -> dict[str, tuple]:
        d = self.input_shape[-1]
        shapes = {"weights": (d,)}
        if self.include_bias:
            shapes["bias"] = (d,)
        return shapes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = self.bias if self.include_bias else None
        y = layer_norm_forward(x, self.weights, beta, self.eps)
        return y.to(self.output_store_dtype)
