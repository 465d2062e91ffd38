"""Max pooling (port of ``MaxPooling`` in ``znicz_tpu/ops/pooling.py``).

Window geometry is the reference's: ``kx``/``ky`` and ``sliding``
(default: the window, no overlap) over NHWC inputs, with the ceil form
of the output size — ``ceil((h − ky) / sy) + 1`` windows, 1 when
``h ≤ ky`` — and the tail windows cut at the edge.  The input is padded
with −inf up to the last window's end where the windows overhang it
(never at AlexNet's 55, 27 and 13), so ``F.max_pool2d`` on the
channels-last view covers exactly the reference's windows.

On a train step (gradients enabled) the unit keeps the winners' indices
for :class:`~znicz_tpu_torch.ops.gd_pooling.GDMaxPooling`: the first
maximum of each window in row-major window order, the element the
reference's select-and-scatter picks.  The other pooling kinds
(max-abs, average, stochastic) arrive with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.nn_units import Forward


class MaxPooling(Forward):
    """Plain max pooling (weightless forward)."""

    def __init__(self, input_shape, compute_dtype: torch.dtype, kx: int,
                 ky: int, sliding=None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if len(self.input_shape) != 3:
            raise ValueError(f"pooling expects (H, W, C) samples, got "
                             f"{self.input_shape}")
        self.kx, self.ky = int(kx), int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)  # the reference's default
        self.sliding = (int(sliding[0]), int(sliding[1]))
        #: the last train step's winners (indices into the padded
        #: input's planes), for the backward unit
        self.indices: torch.Tensor | None = None

    def output_spatial(self, h: int, w: int) -> tuple[int, int]:
        sy, sx = self.sliding
        # ceil-div: tail windows are cut at the edge (the reference's)
        return (-(-(h - self.ky) // sy) + 1 if h > self.ky else 1,
                -(-(w - self.kx) // sx) + 1 if w > self.kx else 1)

    @property
    def output_shape(self) -> tuple:
        h, w, c = self.input_shape
        return (*self.output_spatial(h, w), c)

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def padded_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """x as a channels-last NCHW view, padded with −inf at the bottom
        and right up to the end of the last window."""
        h, w = x.shape[1], x.shape[2]
        oh, ow = self.output_spatial(h, w)
        sy, sx = self.sliding
        ph, pw = (oh - 1) * sy + self.ky - h, (ow - 1) * sx + self.kx - w
        xc = x.permute(0, 3, 1, 2)
        if ph or pw:
            xc = F.pad(xc, (0, pw, 0, ph), value=float("-inf"))
        return xc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = self.padded_nchw(x)
        window = (self.ky, self.kx)
        if torch.is_grad_enabled():
            y, self.indices = F.max_pool2d(xc, window, self.sliding,
                                           return_indices=True)
        else:
            y = F.max_pool2d(xc, window, self.sliding)
        return y.permute(0, 2, 3, 1).to(self.output_store_dtype).contiguous()
