"""Dropout (port of ``znicz_tpu/ops/dropout.py``).

Train mode: zero each activation with probability ``dropout_ratio`` and
scale the survivors by ``1/(1−ratio)`` (inverted dropout, so eval mode
is the identity, as in the reference).  ``forward_mode`` ("train" /
"eval") is linked from the loader in a workflow, as the reference links
it, and set by hand on a unit used alone.

The port runs the reference's fused path: mask generation and apply in
one kernel (:func:`~znicz_tpu_torch.ops.fused_kernels.dropout_apply`),
with no mask array in memory.  Each train step takes its seed from the
unit's :class:`~znicz_tpu_torch.utils.prng.SeedChain`: a seed on the
device, rooted in one draw from the port's default generator and
advanced by the step itself, which the kernel reads through a pointer.
So a captured CUDA graph draws a new mask on every replay, and a run
in chunks sees the masks of a run step by step.  ``DropoutBackward``
applies the mask of the same seed to the error, so the backward
regenerates the forward's mask bit for bit.  The kernel's bits are
Philox4x32-10 of (seed, element index), which the plain version
computes too, so one seed gives the same mask on the card and on the
CPU.  The reference's bits come from the TPU core or from
``jax.random``; only their distribution is owed.

A snapshot carries the chain's next seed (``seed_chain``), so a resumed
run draws the masks the uninterrupted one would have.

On the numpy oracle the mask is the reference's host rule: uniforms
from the default generator's numpy stream, kept where below
``1 − ratio``, scaled by ``1/(1 − ratio)``, held in ``mask`` for the
backward (:meth:`DropoutForward.numpy_mask` draws it).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.fused_kernels import dropout_apply
from znicz_tpu_torch.ops.nn_units import (Forward, Stochastic,
                                          WeightlessGradientUnit)
from znicz_tpu_torch.utils import prng


class DropoutForward(Stochastic, Forward):
    """Inverted dropout (weightless forward)."""

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 dropout_ratio: float = 0.5, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.init_stochastic()
        if not 0.0 <= dropout_ratio < 1.0:
            raise ValueError(f"dropout_ratio {dropout_ratio} not in [0,1)")
        self.dropout_ratio = float(dropout_ratio)
        #: the numpy oracle's mask of the last train step (None in eval)
        self.mask: np.ndarray | None = None

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.forward_mode != "train":
            self.seed = None
            return x.to(self.output_store_dtype)
        seed = self.next_seed(x.device)
        return dropout_apply(x.contiguous(), seed,
                             self.dropout_ratio).to(self.output_store_dtype)

    def numpy_mask(self, shape) -> np.ndarray:
        """The oracle's train mask (the reference's host rule)."""
        keep = 1.0 - self.dropout_ratio
        return (prng.get().numpy.uniform(size=shape) < keep).astype(
            np.float32) / keep

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        if self.forward_mode != "train":
            self.mask = None
            return x
        self.mask = self.numpy_mask(x.shape)
        return x * self.mask


class DropoutBackward(WeightlessGradientUnit):
    """The error through the forward's mask, regenerated from its seed
    (weightless: nothing to update)."""

    MATCHES = (DropoutForward,)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        fwd = self.forward_unit
        if fwd.seed is None:
            return err_output.to(self.act_store_dtype)
        return dropout_apply(err_output.contiguous(), fwd.seed,
                             fwd.dropout_ratio).to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        if not self.need_err_input:
            return None
        mask = self.forward_unit.mask
        return err_output if mask is None else err_output * mask
