"""Depooling ("unpooling") units (port of ``znicz_tpu/ops/depooling.py``).

A :class:`Depooling` is the decoder half of a pooling layer: tied to a
pooling unit (``tied_to``), it takes an input of the pooling's output
shape and gives one of the pooling's input shape, reading the pooling's
input of the same minibatch (``pooling_input``, linked):

- max and max-abs pooling: each value goes to its window's winner in
  the pooling input (the first maximum, or the first largest |x|, in
  row-major window order: the element the pooling picked), zeros
  elsewhere, summed where overlapping windows pick one cell;
- avg pooling: each value spread evenly over its window's cells inside
  the input (a window cut at the edge divides by its true count);
- stochastic pooling raises ``TypeError``, as the reference does.

The reference finds the winners again (the vjp of the pooling's forward
at its input), so the port does too, with one more pooling pass over
the pooling input (``MaxPooling.winners``), on validation minibatches
as on train ones; it does not read the winners the pooling keeps for
its own backward, which that backward consumes.  On a train step the
depooling keeps its winners' indices for :class:`GDDepooling`, which
uses them once.  The windows are those of the pooling: the input padded
with −inf at the bottom and right to the end of the last window, the
result cropped.  The scatter is the max pooling's index backward
(``aten.max_pool2d_with_indices_backward``), in the activation dtype
for max pooling and in f32 for max-abs and avg pooling, as the pooling
backward units sum.

:class:`GDDepooling` is the transpose: the gather of the error at the
winners, or each window's mean error.

On the numpy oracle both run the reference's window loops, copied: the
winner index ``y0 + idx // kx`` over windows padded to full size with
−inf (``Depooling.winner_idx_np``).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import (Forward, WeightlessGradientUnit,
                                          as_numpy, stored_f32)
from znicz_tpu_torch.ops.pooling import AvgPooling, MaxAbsPooling, MaxPooling


class Depooling(Forward):
    """Scatter of the input to the tied pooling's winners (or its
    windows, for avg pooling)."""

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, pooling_unit=None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, include_bias=False,
                         **kwargs)
        self.__dict__["pooling_unit"] = None
        #: the last train step's winners (indices into the padded
        #: pooling input's planes), for the backward unit
        self.indices: torch.Tensor | None = None
        if pooling_unit is not None:
            self.tie(pooling_unit)

    def tie(self, pooling) -> None:
        """Pair with ``pooling`` (a layer's ``tied_to``): its geometry,
        and its ``input`` as :attr:`pooling_input`.  Stochastic pooling
        has no winners to scatter to."""
        if not isinstance(pooling, (MaxPooling, AvgPooling)):
            raise TypeError(f"{self}: unsupported pooling type "
                            f"{type(pooling).__name__}")
        self.__dict__["pooling_unit"] = pooling
        self.link_attrs(pooling, ("pooling_input", "input"))

    @property
    def output_shape(self) -> tuple:
        pool = self.pooling_unit
        if pool is None or pool.input_shape is None:
            raise AttributeError(f"{self}: pooling_unit not set")
        return tuple(pool.input_shape)

    def check_input_shape(self) -> None:
        pool = self.pooling_unit
        if tuple(self.input_shape) != tuple(pool.output_shape):
            raise ValueError(
                f"{self}: input shape {self.input_shape} != paired "
                f"pooling output {pool.output_shape}")

    def initialize(self, device=None, **kwargs) -> None:
        pool = self.pooling_unit
        if pool is None:
            raise AttributeError(f"{self}: pooling_unit not set")
        if not pool.is_initialized:
            raise AttributeError(f"{self}: {pool} not initialized yet")
        super().initialize(device=device, **kwargs)

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    # -- the device path ----------------------------------------------------
    def device_run(self) -> None:
        self.output = self(self.input, self.pooling_input)

    def forward(self, x: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
        """x (the pooling's output shape) scattered onto px's shape."""
        pool = self.pooling_unit
        h, w = px.shape[1], px.shape[2]
        err = x.permute(0, 3, 1, 2)
        if isinstance(pool, AvgPooling):
            grad = torch.ops.aten.avg_pool2d_backward(
                err.float() / pool.counts(h, w, x.device),
                pool.padded_nchw(px.float(), 0.0), [pool.ky, pool.kx],
                list(pool.sliding), [0, 0], False, True, 1)
        else:
            _, indices = pool.winners(px)
            if torch.is_grad_enabled():
                self.indices = indices
            dtype = torch.float32 if isinstance(pool, MaxAbsPooling) \
                else x.dtype
            grad = torch.ops.aten.max_pool2d_with_indices_backward(
                err.to(dtype), pool.padded_nchw(px.to(dtype), float("-inf")),
                [pool.ky, pool.kx], list(pool.sliding), [0, 0], [1, 1],
                False, indices)
        return grad[:, :, :h, :w].permute(0, 2, 3, 1).to(
            self.output_store_dtype).contiguous()

    # -- the numpy oracle (the reference's loops) ---------------------------
    def numpy_run(self) -> None:
        self.output = stored_f32(self.numpy_forward(
            as_numpy(self.input), as_numpy(self.pooling_input)))

    def winner_idx_np(self, px: np.ndarray) -> dict:
        """Each window's winner index in full-window coordinates, by
        ``(oy, ox)`` (the reference's ``_winner_idx_np``)."""
        pool = self.pooling_unit
        n, h, w, c = px.shape
        idx = {}
        for oy, ox, y0, y1, x0, x1 in pool.windows_np(h, w):
            win = np.full((n, pool.ky, pool.kx, c), -np.inf, dtype=px.dtype)
            win[:, :y1 - y0, :x1 - x0, :] = px[:, y0:y1, x0:x1, :]
            win = win.reshape(n, -1, c)
            key = np.abs(win) if isinstance(pool, MaxAbsPooling) else win
            key = np.where(np.isfinite(win), key, -np.inf)
            idx[(oy, ox)] = key.argmax(axis=1)
        return idx

    def numpy_forward(self, x: np.ndarray, px: np.ndarray) -> np.ndarray:
        pool = self.pooling_unit
        n, h, w, c = px.shape
        out = np.zeros(px.shape, np.float32)
        if isinstance(pool, AvgPooling):
            for oy, ox, y0, y1, x0, x1 in pool.windows_np(h, w):
                cnt = (y1 - y0) * (x1 - x0)
                out[:, y0:y1, x0:x1, :] += x[:, oy, ox, None, None, :] / cnt
            return out
        winners = self.winner_idx_np(px)
        bi = np.arange(n)[:, None]
        ci = np.arange(c)[None, :]
        for oy, ox, y0, y1, x0, x1 in pool.windows_np(h, w):
            idx = winners[(oy, ox)]                    # (n, c)
            # one cell per (sample, channel): the reference's loop over
            # them, in one indexed add
            out[bi, y0 + idx // pool.kx, x0 + idx % pool.kx, ci] += \
                x[:, oy, ox, :]
        return out


class GDDepooling(WeightlessGradientUnit):
    """The transpose of the depooling: ``err_input[o]`` is the error at
    the window's winner (max, max-abs) or the window's mean error
    (avg)."""

    MATCHES = (Depooling,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        pool = fwd.pooling_unit
        indices, fwd.indices = fwd.indices, None  # used once
        if not self.need_err_input:
            return None
        n, oh, ow, c = x.shape
        if isinstance(pool, AvgPooling):
            h, w = err_output.shape[1], err_output.shape[2]
            err = pool.window_sums(err_output) / pool.counts(h, w, x.device)
        else:
            if indices is None:
                raise RuntimeError(f"{type(fwd).__name__}: no winners kept "
                                   f"for this step (run the forward with "
                                   f"gradients enabled first)")
            planes = pool.padded_nchw(err_output, 0.0).flatten(2)
            err = planes.gather(2, indices.flatten(2)).view(n, c, oh, ow)
        return err.permute(0, 2, 3, 1).to(self.act_store_dtype).contiguous()

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        fwd = self.forward_unit
        pool = fwd.pooling_unit
        px = as_numpy(fwd.pooling_input)
        n, h, w, c = px.shape
        out = np.zeros(x.shape, np.float32)
        if isinstance(pool, AvgPooling):
            for oy, ox, y0, y1, x0, x1 in pool.windows_np(h, w):
                cnt = (y1 - y0) * (x1 - x0)
                out[:, oy, ox, :] = \
                    err_output[:, y0:y1, x0:x1, :].sum(axis=(1, 2)) / cnt
            return out
        winners = fwd.winner_idx_np(px)
        bi = np.arange(n)[:, None]
        ci = np.arange(c)[None, :]
        for oy, ox, y0, y1, x0, x1 in pool.windows_np(h, w):
            idx = winners[(oy, ox)]
            out[:, oy, ox, :] = err_output[bi, y0 + idx // pool.kx,
                                           x0 + idx % pool.kx, ci]
        return out
