"""Convolution forward units (port of ``znicz_tpu/ops/conv.py``).

``y = act(conv(x, W) + b)`` with the reference's layouts at the unit's
boundary: NHWC activations and HWIO ``(ky, kx, C, K)`` weights, so a
reference state loads unchanged.  The convolution itself is
``F.conv2d`` (cuDNN on the card), as the reference left it to XLA: the
NHWC activations are handed over as an NCHW view whose memory is
channels-last, and the weights as a permuted view, so no activation is
copied to change its layout, and the output comes back channels-last,
which is NHWC again.

Constructor geometry is the reference's: ``n_kernels``, ``kx``/``ky``,
``sliding`` (stride ``(sy, sx)``), ``padding`` (int, ``(v, h)`` or
``(top, bottom, left, right)``).

Rounding points are the reference's ``conv_raw``: in bf16 mode the conv
takes bf16 operands and gives a bf16 output (f32 accumulation inside),
which is then upcast, biased and activated in f32 and stored at the
activation dtype.  The flavors ``ConvTanh``, ``ConvRELU``,
``ConvStrictRELU`` and ``ConvSigmoid`` fuse their activation the same
way.  The backward units are in :mod:`znicz_tpu_torch.ops.gd_conv`.

On the numpy oracle the convolution is the reference's: :func:`im2col`
patches times the flattened weights (and :func:`col2im` for the
backward's error), copied.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops import activations_math
from znicz_tpu_torch.ops.nn_units import Forward


def normalize_padding(padding) -> tuple[int, int, int, int]:
    """→ (top, bottom, left, right)."""
    if isinstance(padding, (int, np.integer)):
        return (int(padding),) * 4
    padding = tuple(int(p) for p in padding)
    if len(padding) == 2:
        v, h = padding
        return (v, v, h, h)
    if len(padding) == 4:
        return padding
    raise ValueError(f"bad padding spec {padding!r}")


def im2col(x: np.ndarray, ky: int, kx: int, sy: int, sx: int,
           pad: tuple[int, int, int, int]) -> np.ndarray:
    """NHWC patches → (N, oh, ow, ky*kx*C) (the reference's oracle
    'unpack', copied)."""
    pt, pb, pl, pr = pad
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    n, h, w, c = xp.shape
    oh = (h - ky) // sy + 1
    ow = (w - kx) // sx + 1
    cols = np.zeros((n, oh, ow, ky, kx, c), dtype=x.dtype)
    for i in range(ky):
        for j in range(kx):
            cols[:, :, :, i, j, :] = \
                xp[:, i:i + oh * sy:sy, j:j + ow * sx:sx, :]
    return cols.reshape(n, oh, ow, ky * kx * c)


def col2im(cols: np.ndarray, x_shape, ky: int, kx: int, sy: int, sx: int,
           pad: tuple[int, int, int, int]) -> np.ndarray:
    """Patches added back into an NHWC array of ``x_shape`` (the
    reference's oracle col2im, copied)."""
    pt, pb, pl, pr = pad
    n, h, w, c = x_shape
    hp, wp = h + pt + pb, w + pl + pr
    out = np.zeros((n, hp, wp, c), dtype=cols.dtype)
    oh = (hp - ky) // sy + 1
    ow = (wp - kx) // sx + 1
    cols6 = cols.reshape(n, oh, ow, ky, kx, c)
    for i in range(ky):
        for j in range(kx):
            out[:, i:i + oh * sy:sy, j:j + ow * sx:sx, :] += \
                cols6[:, :, :, i, j, :]
    return out[:, pt:pt + h, pl:pl + w, :]


class Conv(Forward):
    """2-D convolution (linear flavor)."""

    ACTIVATION = "linear"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, n_kernels: int = 1, kx: int = 1,
                 ky: int = 1, sliding=(1, 1), padding=0, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        self.sliding = (int(sliding[0]), int(sliding[1]))  # (sy, sx)
        self.padding = normalize_padding(padding)
        self.activation = activations_math.get(self.ACTIVATION)
        if self.input_shape is not None:
            self.check_input_shape()

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 3:
            raise ValueError(f"conv expects (H, W, C) samples, got "
                             f"{self.input_shape}")

    def output_spatial(self, h: int, w: int) -> tuple[int, int]:
        pt, pb, pl, pr = self.padding
        sy, sx = self.sliding
        return ((h + pt + pb - self.ky) // sy + 1,
                (w + pl + pr - self.kx) // sx + 1)

    @property
    def output_shape(self) -> tuple:
        h, w, _ = self.input_shape
        return (*self.output_spatial(h, w), self.n_kernels)

    def param_shapes(self) -> dict[str, tuple]:
        c = self.input_shape[2]
        shapes = {"weights": (self.ky, self.kx, c, self.n_kernels)}
        if self.include_bias:
            shapes["bias"] = (self.n_kernels,)
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        shapes = self.param_shapes()
        fan_in = self.ky * self.kx * self.input_shape[2]
        params = {"weights": self.fill_array(
            shapes["weights"], self.weights_filling, self.weights_stddev,
            fan_in=fan_in)}
        if self.include_bias:
            params["bias"] = self.fill_array(
                shapes["bias"], self.bias_filling, self.bias_stddev,
                fan_in=fan_in)
        return params

    # -- the bare convolution (the backward unit differentiates it) ------
    def conv_dtype(self) -> torch.dtype:
        """The conv's operand and output dtype: bf16 in bf16 mode."""
        return self.mxu_dtype or torch.float32

    @property
    def even_padding(self) -> bool:
        pt, pb, pl, pr = self.padding
        return pt == pb and pl == pr

    def nchw_operands(self, x: torch.Tensor, w: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, tuple]:
        """``(x as a channels-last NCHW view, padded beforehand when the
        padding is uneven; W as a (K, C, ky, kx) view; the conv's own
        symmetric padding)``, both at :meth:`conv_dtype`."""
        dt = self.conv_dtype()
        pt, pb, pl, pr = self.padding
        xc = x.to(dt).permute(0, 3, 1, 2)
        if self.even_padding:
            return xc, w.to(dt).permute(3, 2, 0, 1), (pt, pl)
        return (F.pad(xc, (pl, pr, pt, pb)), w.to(dt).permute(3, 2, 0, 1),
                (0, 0))

    def conv_raw(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC x, HWIO w → NHWC output at :meth:`conv_dtype` (bf16
        operands → bf16 output in bf16 mode, as the reference's)."""
        xc, wc, pad = self.nchw_operands(x, w)
        return F.conv2d(xc, wc, stride=self.sliding,
                        padding=pad).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_raw(x, self.weights).float()
        if self.include_bias:
            y = y + self.bias
        return self.activation.fwd(y).to(
            self.output_store_dtype).contiguous()

    def im2col(self, x: np.ndarray) -> np.ndarray:
        return im2col(x, self.ky, self.kx, *self.sliding, self.padding)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        y = self.im2col(x.astype(np.float32)) \
            @ self.np_param("weights").reshape(-1, self.n_kernels)
        if self.include_bias:
            y = y + self.np_param("bias")
        return self.activation.np_fwd(y)


class ConvTanh(Conv):
    """Scaled-tanh flavor."""
    ACTIVATION = "tanh"


class ConvRELU(Conv):
    """Smooth-RELU flavor."""
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    """max(x, 0) flavor."""
    ACTIVATION = "strict_relu"


class ConvSigmoid(Conv):
    """Sigmoid flavor."""
    ACTIVATION = "sigmoid"
