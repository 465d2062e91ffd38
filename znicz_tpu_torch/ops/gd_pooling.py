"""Max-pooling backward (port of ``GDMaxPooling`` in
``znicz_tpu/ops/gd_pooling.py``).

The error of each window goes to the element the forward picked, the
first maximum of the window (the reference's select-and-scatter), and
sums where overlapping windows picked the same element.  The forward
kept the winners' indices on this train step, so nothing is recomputed:
one ``aten.max_pool2d_with_indices_backward`` scatters the error.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.ops.nn_units import GradientDescentBase
from znicz_tpu_torch.ops.pooling import MaxPooling


class GDMaxPooling(GradientDescentBase):
    """Scatter of the error to the forward's winners (weightless)."""

    MATCHES = (MaxPooling,)

    @torch.no_grad()
    def run(self, x: torch.Tensor, err_output: torch.Tensor,
            y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        indices, fwd.indices = fwd.indices, None  # used once
        if not self.need_err_input:
            return None
        if indices is None:
            raise RuntimeError(f"{type(fwd).__name__}: no winners kept for "
                               f"this step (run the forward with gradients "
                               f"enabled first)")
        xc = fwd.padded_nchw(x)
        grad = torch.ops.aten.max_pool2d_with_indices_backward(
            err_output.to(x.dtype).permute(0, 3, 1, 2), xc,
            [fwd.ky, fwd.kx], list(fwd.sliding), [0, 0], [1, 1], False,
            indices)
        h, w = x.shape[1], x.shape[2]
        return grad[:, :, :h, :w].permute(0, 2, 3, 1).to(
            self.act_store_dtype).contiguous()
