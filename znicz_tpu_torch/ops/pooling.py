"""Pooling forward units (port of ``znicz_tpu/ops/pooling.py``).

Window geometry is the reference's, in :class:`Pooling`: ``kx``/``ky``
and ``sliding`` (default: the window, no overlap) over NHWC inputs, with
the ceil form of the output size — ``ceil((h − ky) / sy) + 1`` windows,
1 when ``h ≤ ky`` — and the tail windows cut at the edge.  Each unit
pads its input at the bottom and right up to the end of the last window
and marks the padded cells so that none can win or count:

- :class:`MaxPooling` — the window's maximum (``F.max_pool2d`` over −inf
  padding).  On a train step (gradients enabled) it keeps the winners'
  indices: the first maximum in row-major window order, the element the
  reference's select-and-scatter picks.
- :class:`MaxAbsPooling` — the element of largest |x|, its sign kept:
  the window's maximum or its minimum, from two max pools (of x and of
  −x, both padded with −inf, so a padded cell never wins).  Where
  |max| = |min| the first of the two cells in row-major window order
  wins, as in the reference (its indices into the padded plane grow in
  that order), so a signed tie goes where the reference sends it.  A
  train step keeps the winners' indices, which the max-pooling backward
  takes as they are.
- :class:`AvgPooling` — the window's sum over the count of its cells
  inside the input, so a cut window divides by its true count.
- :class:`StochasticPooling` — on a train step one element of each
  window, drawn with probability ∝ max(x, 0) (uniformly over the window's
  cells inside the input when none is positive), recorded in
  ``last_choice`` in full-window coordinates; in eval mode the
  probability-weighted mean.  Each train step takes its seed from the
  unit's device seed chain (:class:`~znicz_tpu_torch.utils.prng.SeedChain`),
  as the dropout unit does, and its uniforms from the Philox bits of
  that seed, whose stream differs from the reference's (only the
  distribution is owed).

The reference computes pooling in XLA (``lax.reduce_window`` and
gathers), not in Pallas, so these are PyTorch operations: no kernel of
the TPU has a counterpart here.  On the numpy oracle each unit runs the
reference's window loop (:meth:`Pooling.windows_np`), stochastic
pooling drawing its uniforms from the default generator's numpy stream
as the reference's oracle does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops.fused_kernels import block_bits
from znicz_tpu_torch.ops.nn_units import Forward, Stochastic
from znicz_tpu_torch.utils import prng


class Pooling(Forward):
    """Base pooling unit (weightless forward): the window geometry."""

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, kx: int = 2, ky: int = 2, sliding=None,
                 **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.kx, self.ky = int(kx), int(ky)
        if sliding is None:
            sliding = (self.ky, self.kx)  # the reference's default
        self.sliding = (int(sliding[0]), int(sliding[1]))
        if self.input_shape is not None:
            self.check_input_shape()

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 3:
            raise ValueError(f"pooling expects (H, W, C) samples, got "
                             f"{self.input_shape}")

    def output_spatial(self, h: int, w: int) -> tuple[int, int]:
        sy, sx = self.sliding
        # ceil-div: tail windows are cut at the edge (the reference's)
        return (-(-(h - self.ky) // sy) + 1 if h > self.ky else 1,
                -(-(w - self.kx) // sx) + 1 if w > self.kx else 1)

    @property
    def output_shape(self) -> tuple:
        h, w, c = self.input_shape
        return (*self.output_spatial(h, w), c)

    @property
    def window(self) -> int:
        return self.ky * self.kx

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def padded_nchw(self, x: torch.Tensor, value: float) -> torch.Tensor:
        """x as a channels-last NCHW view, padded with ``value`` at the
        bottom and right up to the end of the last window."""
        h, w = x.shape[1], x.shape[2]
        oh, ow = self.output_spatial(h, w)
        sy, sx = self.sliding
        ph, pw = (oh - 1) * sy + self.ky - h, (ow - 1) * sx + self.kx - w
        xc = x.permute(0, 3, 1, 2)
        if ph or pw:
            xc = F.pad(xc, (0, pw, 0, ph), value=value)
        return xc

    def store(self, y_nchw: torch.Tensor) -> torch.Tensor:
        """An ``(n, c, oh, ow)`` result as this unit's NHWC output."""
        return y_nchw.permute(0, 2, 3, 1).to(
            self.output_store_dtype).contiguous()

    def windows_np(self, h: int, w: int):
        """The oracle's windows: ``(oy, ox, y0, y1, x0, x1)``, cut at the
        edge (the reference's ``_windows``)."""
        sy, sx = self.sliding
        oh, ow = self.output_spatial(h, w)
        for oy in range(oh):
            y0 = oy * sy
            for ox in range(ow):
                x0 = ox * sx
                yield (oy, ox, y0, min(y0 + self.ky, h),
                       x0, min(x0 + self.kx, w))

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        n, h, w, c = x.shape
        out = np.zeros((n, *self.output_spatial(h, w), c), np.float32)
        for oy, ox, y0, y1, x0, x1 in self.windows_np(h, w):
            out[:, oy, ox, :] = self.pool_np(x[:, y0:y1, x0:x1, :])
        return out

    def pool_np(self, win: np.ndarray) -> np.ndarray:
        """One (n, wh, ww, c) window of the input → (n, c)."""
        raise NotImplementedError(f"{type(self).__name__}.pool_np")


class MaxPooling(Pooling):
    """Plain max pooling."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        #: the last train step's winners (indices into the padded
        #: input's planes), for the backward unit
        self.indices: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            y, self.indices = self.winners(x)
        else:
            y = F.max_pool2d(self.padded_nchw(x, float("-inf")),
                             (self.ky, self.kx), self.sliding)
        return self.store(y)

    def winners(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(y, indices)`` of x, NCHW: each window's pick and its index
        into the padded input's plane, kept by nothing (the depooling
        finds a tied pooling's winners through it)."""
        return F.max_pool2d(self.padded_nchw(x, float("-inf")),
                            (self.ky, self.kx), self.sliding,
                            return_indices=True)

    def pool_np(self, win):
        return win.max(axis=(1, 2))


class MaxAbsPooling(MaxPooling):
    """Largest-|x| element of each window, its sign kept."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, indices = self.winners(x, torch.is_grad_enabled())
        if indices is not None:
            self.indices = indices
        return self.store(y)

    def winners(self, x, with_indices: bool = True):
        window = (self.ky, self.kx)
        hi, i_hi = F.max_pool2d(self.padded_nchw(x, float("-inf")), window,
                                self.sliding, return_indices=True)
        lo, i_lo = F.max_pool2d(self.padded_nchw(-x, float("-inf")), window,
                                self.sliding, return_indices=True)
        # lo is −min, and max ≥ min, so |max| > |min| where hi > lo; the
        # first cell wins where |max| = |min|
        take_hi = (hi > lo) | ((hi == lo) & (i_hi <= i_lo))
        return (torch.where(take_hi, hi, -lo),
                torch.where(take_hi, i_hi, i_lo) if with_indices else None)

    def pool_np(self, win):
        n, c = win.shape[0], win.shape[3]
        win = win.reshape(n, -1, c)
        idx = np.abs(win).argmax(axis=1)
        return np.take_along_axis(win, idx[:, None, :], axis=1)[:, 0, :]


class AvgPooling(Pooling):
    """Window mean; a cut tail window divides by its true count."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._counts: dict = {}

    def counts(self, h: int, w: int, device) -> torch.Tensor:
        """``(oh, ow)`` f32: the cells of each window inside the input."""
        key = (h, w, str(device))
        if key not in self._counts:
            ones = torch.ones(1, h, w, 1, device=device)
            self._counts[key] = self.window_sums(ones)[0, 0]
        return self._counts[key]

    def window_sums(self, x: torch.Tensor) -> torch.Tensor:
        """``(n, c, oh, ow)`` f32 sums of each window (zero padding)."""
        return F.avg_pool2d(self.padded_nchw(x.float(), 0.0),
                            (self.ky, self.kx), self.sliding,
                            divisor_override=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        return self.store(self.window_sums(x) / self.counts(h, w, x.device))

    def pool_np(self, win):
        return win.mean(axis=(1, 2))


class StochasticPooling(Stochastic, Pooling):
    """Train: one element of each window drawn ∝ max(x, 0); eval: the
    probability-weighted mean.  ``forward_mode`` ("train"/"eval") is
    linked from the loader in a workflow.  A train step takes its seed
    from the unit's device seed chain (as dropout does) and its uniform
    draws from the Philox bits of that seed
    (:func:`~znicz_tpu_torch.ops.fused_kernels.block_bits`, on the
    device, with no host sync), so a captured graph draws anew on each
    replay.  The bits of window ``(i, c, oy, ox)`` are those of its
    index in the global batch's ``(n, c, oh, ow)`` windows, so on a
    data axis each process draws its rows of the one draw of the whole
    batch."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.init_stochastic()
        #: the last train step's choices, NHWC ``(n, oh, ow, c)`` int32
        #: offsets in full-window coordinates (the reference's layout)
        self.last_choice: torch.Tensor | None = None

    def windows(self, x: torch.Tensor) -> torch.Tensor:
        """Every window of x as ``(n, c, ky·kx, oh, ow)``, the cells in
        row-major window order, −inf on the padded ones (one copy of a
        strided view; ``F.unfold`` loops over the samples)."""
        n, h, w, c = x.shape
        sy, sx = self.sliding
        view = self.padded_nchw(x, float("-inf")).unfold(
            2, self.ky, sy).unfold(3, self.kx, sx)  # (n, c, oh, ow, ky, kx)
        return view.permute(0, 1, 4, 5, 2, 3).reshape(
            n, c, self.window, *self.output_spatial(h, w))

    def scatter_windows(self, err_wins: torch.Tensor,
                        x_shape) -> torch.Tensor:
        """The inverse of :meth:`windows`: each window cell's error
        ``(n, c, ky·kx, oh, ow)`` added into an NHWC tensor of
        ``x_shape`` (overlapping windows sum, in window order; padded
        cells drop)."""
        n, h, w, c = x_shape
        oh, ow = self.output_spatial(h, w)
        sy, sx = self.sliding
        out = err_wins.new_zeros(
            (n, c, (oh - 1) * sy + self.ky, (ow - 1) * sx + self.kx))
        for cell in range(self.window):
            i, j = divmod(cell, self.kx)
            out[:, :, i:i + (oh - 1) * sy + 1:sy,
                j:j + (ow - 1) * sx + 1:sx] += err_wins[:, :, cell]
        return out[:, :, :h, :w].permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wins = self.windows(x).float()
        valid = torch.isfinite(wins)
        wins0 = torch.where(valid, wins, torch.zeros_like(wins))
        pos = torch.clamp(wins0, min=0.0)
        total = pos.sum(dim=2, keepdim=True)
        uniform = valid.float() / valid.sum(dim=2, keepdim=True).clamp(
            min=1).float()
        probs = torch.where(total > 0, pos / torch.where(
            total > 0, total, torch.ones_like(total)), uniform)
        if self.forward_mode != "train":
            self.seed = None
            return self.store((probs * wins0).sum(dim=2))
        self.next_seed(x.device)
        n, c, _, oh, ow = wins.shape
        # 24 random bits a window, a uniform draw in [0, 1); on a mesh
        # this process's rows of the draw of the global batch
        bits = block_bits(n, c * oh * ow, self.seed, x.device,
                          self.block_map(wins[:, :, 0]))
        r = ((bits >> 8).float() * 2.0 ** -24).view(n, c, 1, oh, ow)
        cum = probs.cumsum(dim=2)
        # no draw may land past the last cell with mass when the sum of
        # the probabilities rounds under r
        cum = torch.where(cum >= cum[:, :, -1:], float("inf"), cum)
        idx = (r > cum).sum(dim=2, keepdim=True)
        self.last_choice = idx[:, :, 0].permute(0, 2, 3, 1).to(
            torch.int32).contiguous()
        return self.store(wins0.gather(2, idx).squeeze(2))

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        """The reference's oracle: each window padded to its full size
        with −inf, the draw from the default generator's numpy stream,
        the choice in full-window coordinates."""
        n, h, w, c = x.shape
        oh, ow = self.output_spatial(h, w)
        out = np.zeros((n, oh, ow, c), np.float32)
        train = self.forward_mode == "train"
        choice = np.zeros((n, oh, ow, c), np.int32) if train else None
        rnd = prng.get().numpy
        for oy, ox, y0, y1, x0, x1 in self.windows_np(h, w):
            win = np.full((n, self.ky, self.kx, c), -np.inf, dtype=x.dtype)
            win[:, :y1 - y0, :x1 - x0, :] = x[:, y0:y1, x0:x1, :]
            win = win.reshape(n, self.window, c)
            valid = np.isfinite(win)
            win0 = np.where(valid, win, 0.0)
            pos = np.maximum(win0, 0.0) * valid
            total = pos.sum(axis=1, keepdims=True)
            kcnt = valid.sum(axis=1, keepdims=True).astype(x.dtype)
            uniform = valid.astype(x.dtype) / np.maximum(kcnt, 1.0)
            p = np.where(total > 0,
                         pos / np.where(total > 0, total, 1.0), uniform)
            if train:
                cum = p.cumsum(axis=1)
                r = rnd.uniform(size=(n, 1, c))
                idx = (r > cum).sum(axis=1)
                out[:, oy, ox, :] = np.take_along_axis(
                    win0, idx[:, None, :], axis=1)[:, 0, :]
                choice[:, oy, ox, :] = idx
            else:
                out[:, oy, ox, :] = (p * win0).sum(axis=1)
        self.last_choice = choice
        return out
