"""Transposed convolution ("deconvolution") forward units (port of
``znicz_tpu/ops/deconv.py``).

A :class:`Deconv` is the decoder half of a convolutional autoencoder: it
inverts the geometry of a paired :class:`~znicz_tpu_torch.ops.conv.Conv`
(``n_kernels``, ``kx``/``ky``, ``sliding``, ``padding``).  Its input has
``n_kernels`` channels, its output the shape of the paired conv's input
(:attr:`Deconv.output_shape_source`), and it may share the conv's
weights (a tied autoencoder).  Layouts are the reference's: NHWC
activations and HWIO ``(ky, kx, C, K)`` weights, C the output's
channels; no bias unless ``include_bias``.

The forward is the transpose of the paired conv at the conv dtype (bf16
operands give a bf16 result in bf16 mode), then f32, the bias and the
activation, as the reference's ``deconv_raw``/``xla_forward``:

.. code-block:: text

    y = act(conv_transpose(x, W) + b)

On the card that is ``F.conv_transpose2d`` (cuDNN's data-gradient
convolution) on the NHWC tensors' channels-last NCHW views.  Where the
paired conv's floor drops rows or columns (a 28² input under a 5×5
stride-2 conv gives 12², whose plain transpose is 27²), the missing
ones take ``output_padding`` and receive no contribution, as the
reference's ``linear_transpose`` onto the source shape leaves them;
uneven padding is transposed onto the padded plane and cut, as the
conv's backward cuts it.  The conv's own checks hold at initialize:
``conv(output shape) == input shape``, with the reference's messages.

On the numpy oracle the forward is the reference's ``x @ Wᵀ`` and
:func:`~znicz_tpu_torch.ops.conv.col2im`, copied.  The backward unit is
in :mod:`znicz_tpu_torch.ops.gd_deconv`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops import activations_math
from znicz_tpu_torch.ops.conv import Conv, col2im, normalize_padding
from znicz_tpu_torch.ops.nn_units import Forward


class Deconv(Forward):
    """Transposed 2-D convolution (linear flavor)."""

    ACTIVATION = "linear"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, n_kernels: int = 1, kx: int = 1,
                 ky: int = 1, sliding=(1, 1), padding=0,
                 include_bias: bool = False, output_shape_source=None,
                 **kwargs) -> None:
        super().__init__(input_shape, compute_dtype,
                         include_bias=include_bias, **kwargs)
        self.n_kernels = int(n_kernels)
        self.kx, self.ky = int(kx), int(ky)
        self.sliding = (int(sliding[0]), int(sliding[1]))  # (sy, sx)
        self.padding = normalize_padding(padding)
        self.activation = activations_math.get(self.ACTIVATION)
        #: what defines the output's per-sample shape (the reference's
        #: ``get_output_shape_from``): the paired conv unit, whose
        #: ``input_shape`` it is, or an ``(H, W, C)`` tuple
        self.__dict__["output_shape_source"] = output_shape_source

    # the paired conv's geometry and operands (the same code)
    conv_spatial = Conv.output_spatial
    conv_dtype = Conv.conv_dtype
    even_padding = Conv.even_padding
    nchw_operands = Conv.nchw_operands

    def tie(self, conv: Forward, weights: bool = False) -> None:
        """Pair with ``conv`` (a layer's ``tied_to``): the output takes
        the conv's input shape and, with ``weights`` (``tied_weights``),
        the conv's weights tensor itself.  Neither unit becomes the
        other's submodule."""
        self.__dict__["output_shape_source"] = conv
        if weights:
            self.link_attrs(conv, "weights")

    @property
    def weights_tied(self) -> bool:
        """True when ``weights`` is linked to the paired conv's."""
        return "weights" in self._linked_attrs

    @property
    def output_shape(self) -> tuple:
        src = self.output_shape_source
        if src is None:
            raise ValueError(
                f"{self}: output_shape_source not linked — link it to the "
                f"paired conv (reference: get_output_shape_from)")
        if isinstance(src, Forward):
            if src.input_shape is None:
                raise AttributeError(f"{self}: {src} not initialized yet")
            return tuple(src.input_shape)
        return tuple(int(n) for n in src)

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 3:
            raise ValueError(f"deconv expects (H, W, K) samples, got "
                             f"{self.input_shape}")
        ih, iw, k = self.input_shape
        if k != self.n_kernels:
            raise ValueError(f"{self}: input has {k} channels, "
                             f"expected n_kernels={self.n_kernels}")
        out = self.output_shape
        oh, ow = self.conv_spatial(out[0], out[1])
        if (oh, ow) != (ih, iw):
            raise ValueError(
                f"{self}: conv({out[:2]}) = {(oh, ow)} does not match "
                f"input spatial {(ih, iw)} — bad deconv geometry")

    def initialize(self, device=None, **kwargs) -> None:
        src = self.output_shape_source
        if isinstance(src, Forward) and not src.is_initialized:
            raise AttributeError(f"{self}: {src} not initialized yet")
        super().initialize(device=device, **kwargs)

    def param_shapes(self) -> dict[str, tuple]:
        c = self.output_shape[2]
        shapes = {}
        if not self.weights_tied:  # else the paired conv's
            shapes["weights"] = (self.ky, self.kx, c, self.n_kernels)
        if self.include_bias:
            shapes["bias"] = (c,)
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        shapes = self.param_shapes()
        fan_in = self.ky * self.kx * self.output_shape[2]
        params = {}
        if "weights" in shapes:
            params["weights"] = self.fill_array(
                shapes["weights"], self.weights_filling, self.weights_stddev,
                fan_in=fan_in)
        if self.include_bias:
            params["bias"] = self.fill_array(
                shapes["bias"], self.bias_filling, self.bias_stddev,
                fan_in=fan_in)
        return params

    # -- the bare transposed convolution --------------------------------
    def paired_conv_raw(self, y: torch.Tensor, w: torch.Tensor
                        ) -> torch.Tensor:
        """The paired forward conv (output space → input space) of NHWC
        ``y`` at the conv dtype: the backward's ``err_input``."""
        yc, wc, pad = self.nchw_operands(y, w)
        return F.conv2d(yc, wc, stride=self.sliding,
                        padding=pad).permute(0, 2, 3, 1)

    def deconv_raw(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC x, HWIO w → the NHWC transposed conv at the conv dtype,
        onto the output shape."""
        dt = self.conv_dtype()
        h, w_out = self.output_shape[:2]
        pt, pb, pl, pr = self.padding
        if self.even_padding:
            pad, hp, wp = (pt, pl), h, w_out
        else:  # onto the padded plane, then cut
            pad, hp, wp = (0, 0), h + pt + pb, w_out + pl + pr
        sy, sx = self.sliding
        ih, iw = x.shape[1], x.shape[2]
        # the rows and columns the conv's floor dropped
        extra = (hp - ((ih - 1) * sy - 2 * pad[0] + self.ky),
                 wp - ((iw - 1) * sx - 2 * pad[1] + self.kx))
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               w.to(dt).permute(3, 2, 0, 1),
                               stride=self.sliding, padding=pad,
                               output_padding=extra)
        if not self.even_padding:
            y = y[:, :, pt:pt + h, pl:pl + w_out]
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.deconv_raw(x, self.weights).float()
        if self.include_bias:
            y = y + self.bias
        return self.activation.fwd(y).to(
            self.output_store_dtype).contiguous()

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        x = x.astype(np.float32)
        w = self.np_param("weights")
        n, ih, iw, k = x.shape
        w2d = w.reshape(-1, k)                      # (ky*kx*C, K)
        cols = (x.reshape(-1, k) @ w2d.T).reshape(n, ih, iw, w2d.shape[0])
        out = col2im(cols, (n, *self.output_shape), self.ky, self.kx,
                     *self.sliding, self.padding)
        if self.include_bias:
            out = out + self.np_param("bias")
        return self.activation.np_fwd(out)


class DeconvTanh(Deconv):
    """Scaled-tanh flavor."""
    ACTIVATION = "tanh"


class DeconvRELU(Deconv):
    """Smooth-RELU flavor."""
    ACTIVATION = "relu"


class DeconvSigmoid(Deconv):
    """Sigmoid flavor."""
    ACTIVATION = "sigmoid"
