"""Pooling backward units (port of ``znicz_tpu/ops/gd_pooling.py``).

Each sends the error of a window to the cells its forward read, and
sums where overlapping windows reach the same cell:

- :class:`GDMaxPooling` — to the element the forward picked, the first
  maximum of the window.  The forward kept the winners' indices on this
  train step, so one ``aten.max_pool2d_with_indices_backward`` scatters
  the error (in the activation dtype).
- :class:`GDMaxAbsPooling` — to the largest-|x| element the forward
  picked: its kept indices go through the same scatter, in f32.
- :class:`GDAvgPooling` — spread over the window's cells inside the
  input, each taking the window's error over their count
  (``aten.avg_pool2d_backward`` of the forward's window sums).
- :class:`GDStochasticPooling` — to the element the forward drew
  (``last_choice``, full-window coordinates).

The MaxAbs, average and stochastic backwards sum their errors in f32
and store them once in the activation dtype.  On the numpy oracle each
runs the reference's window loop: the winners found again by
``argmax`` and the error added at them (``np.add.at``), the average
spread by count, the stochastic choices read back.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import WeightlessGradientUnit
from znicz_tpu_torch.ops.pooling import (AvgPooling, MaxAbsPooling,
                                         MaxPooling, StochasticPooling)


class GDPoolingBase(WeightlessGradientUnit):
    """Weightless backward in f32: ``err_output`` → ``err_input``."""

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        dx = self.input_error(x, err_output.float().permute(0, 3, 1, 2))
        return dx.to(self.act_store_dtype).contiguous()

    def input_error(self, x: torch.Tensor, err: torch.Tensor
                    ) -> torch.Tensor:
        """The NHWC f32 error at the input from the NCHW f32 error
        ``err`` at the output."""
        raise NotImplementedError


class GDMaxPooling(WeightlessGradientUnit):
    """Scatter of the error to the forward's winners, summed in the
    activation dtype (as the reference's select-and-scatter sums, which
    AlexNet's bf16 step is held to)."""

    MATCHES = (MaxPooling,)
    SUM_IN_F32 = False
    #: the winner is the largest |x| (MaxAbs), else the largest x
    USE_ABS = False

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        indices, fwd.indices = fwd.indices, None  # used once
        if not self.need_err_input:
            return None
        if indices is None:
            raise RuntimeError(f"{type(fwd).__name__}: no winners kept for "
                               f"this step (run the forward with gradients "
                               f"enabled first)")
        dtype = torch.float32 if self.SUM_IN_F32 else x.dtype
        xc = fwd.padded_nchw(x.to(dtype), float("-inf"))
        grad = torch.ops.aten.max_pool2d_with_indices_backward(
            err_output.to(dtype).permute(0, 3, 1, 2), xc,
            [fwd.ky, fwd.kx], list(fwd.sliding), [0, 0], [1, 1], False,
            indices)
        h, w = x.shape[1], x.shape[2]
        return grad[:, :, :h, :w].permute(0, 2, 3, 1).to(
            self.act_store_dtype).contiguous()

    def numpy_backprop(self, x, err_output, y=None):
        """The error added at each window's winner (the reference's
        ``_numpy_scatter``)."""
        if not self.need_err_input:
            return None
        fwd = self.forward_unit
        n, h, w, c = x.shape
        out = np.zeros(x.shape, np.float32)
        bi = np.arange(n)[:, None]
        ci = np.arange(c)[None, :]
        for oy, ox, y0, y1, x0, x1 in fwd.windows_np(h, w):
            win = x[:, y0:y1, x0:x1, :].reshape(n, -1, c)
            idx = (np.abs(win) if self.USE_ABS else win).argmax(axis=1)
            ww = x1 - x0
            np.add.at(out, (bi, y0 + idx // ww, x0 + idx % ww, ci),
                      err_output[:, oy, ox, :])
        return out


class GDMaxAbsPooling(GDMaxPooling):
    """Scatter of the error to the forward's largest-|x| elements, summed
    in f32 as the average and stochastic backwards sum."""

    MATCHES = (MaxAbsPooling,)
    SUM_IN_F32 = True
    USE_ABS = True


class GDAvgPooling(GDPoolingBase):
    """The error spread evenly over each window's cells in the input."""

    MATCHES = (AvgPooling,)

    def input_error(self, x, err):
        fwd = self.forward_unit
        h, w = x.shape[1], x.shape[2]
        xc = fwd.padded_nchw(x.float(), 0.0)
        grad = torch.ops.aten.avg_pool2d_backward(
            err / fwd.counts(h, w, x.device), xc, [fwd.ky, fwd.kx],
            list(fwd.sliding), [0, 0], False, True, 1)
        return grad[:, :, :h, :w].permute(0, 2, 3, 1)

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        n, h, w, c = x.shape
        out = np.zeros(x.shape, np.float32)
        for oy, ox, y0, y1, x0, x1 in self.forward_unit.windows_np(h, w):
            count = (y1 - y0) * (x1 - x0)
            out[:, y0:y1, x0:x1, :] += \
                err_output[:, oy, ox, None, None, :].reshape(n, 1, 1, c) \
                / count
        return out


class GDStochasticPooling(GDPoolingBase):
    """Scatter of the error to the elements the forward drew."""

    MATCHES = (StochasticPooling,)

    def input_error(self, x, err):
        fwd = self.forward_unit
        choice, fwd.last_choice = fwd.last_choice, None  # used once
        if choice is None:
            raise RuntimeError("StochasticPooling: no choice kept for this "
                               "step (run the forward in train mode first)")
        n, c, oh, ow = err.shape
        wins = torch.zeros((n, c, fwd.window, oh, ow), dtype=err.dtype,
                           device=err.device)
        # the choices are NHWC offsets in full-window coordinates
        wins.scatter_(2, choice.permute(0, 3, 1, 2).unsqueeze(2).long(),
                      err.unsqueeze(2))
        return fwd.scatter_windows(wins, x.shape)

    def numpy_backprop(self, x, err_output, y=None):
        fwd = self.forward_unit
        choice, fwd.last_choice = fwd.last_choice, None  # used once
        if not self.need_err_input:
            return None
        if choice is None:
            raise RuntimeError("StochasticPooling: no choice kept for this "
                               "step (run the forward in train mode first)")
        n, h, w, c = x.shape
        out = np.zeros(x.shape, np.float32)
        bi = np.arange(n)[:, None]
        ci = np.arange(c)[None, :]
        for oy, ox, y0, y1, x0, x1 in fwd.windows_np(h, w):
            idx = choice[:, oy, ox, :]  # full-window coordinates
            np.add.at(out, (bi, y0 + idx // fwd.kx, x0 + idx % fwd.kx, ci),
                      err_output[:, oy, ox, :])
        return out
