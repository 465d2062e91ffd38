"""Dropout (port of ``znicz_tpu/ops/dropout.py``).

Train mode: zero each activation with probability ``dropout_ratio`` and
scale the survivors by ``1/(1−ratio)`` (inverted dropout, so eval mode
is the identity, as in the reference).  ``forward_mode`` ("train" /
"eval") is set by the workflow from the minibatch class, as the
reference links it from the loader.

The port runs the reference's fused path: mask generation and apply in
one kernel (:func:`~znicz_tpu_torch.ops.fused_kernels.dropout_apply`),
with no mask array in memory.  Each train step draws one seed on the
host from the port's default generator
(:mod:`znicz_tpu_torch.utils.prng`); ``DropoutBackward`` applies the
mask of the same seed to the error, so the backward regenerates the
forward's mask bit for bit.  The kernel's bits are Philox4x32-10 of
(seed, element index), which the plain version computes too, so one
seed gives the same mask on the card and on the CPU.  The reference's
bits come from the TPU core or from ``jax.random``; only their
distribution is owed.
"""

from __future__ import annotations

import torch

from znicz_tpu_torch.ops.fused_kernels import dropout_apply
from znicz_tpu_torch.ops.nn_units import Forward, GradientDescentBase
from znicz_tpu_torch.utils import prng


class DropoutForward(Forward):
    """Inverted dropout (weightless forward)."""

    def __init__(self, input_shape, compute_dtype: torch.dtype,
                 dropout_ratio: float = 0.5, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        if not 0.0 <= dropout_ratio < 1.0:
            raise ValueError(f"dropout_ratio {dropout_ratio} not in [0,1)")
        self.dropout_ratio = float(dropout_ratio)
        self.forward_mode = "train"
        #: this step's mask seed (None in eval mode)
        self.seed: int | None = None

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.forward_mode != "train":
            self.seed = None
            return x.to(self.output_store_dtype)
        self.seed = int(prng.get().randint(0, 2 ** 63))
        return dropout_apply(x.contiguous(), self.seed,
                             self.dropout_ratio).to(self.output_store_dtype)


class DropoutBackward(GradientDescentBase):
    """The error through the forward's mask, regenerated from its seed
    (weightless: nothing to update)."""

    MATCHES = (DropoutForward,)

    @torch.no_grad()
    def run(self, x: torch.Tensor, err_output: torch.Tensor,
            y: torch.Tensor | None = None) -> torch.Tensor | None:
        if not self.need_err_input:
            return None
        fwd = self.forward_unit
        if fwd.seed is None:
            return err_output.to(self.act_store_dtype)
        return dropout_apply(err_output.contiguous(), fwd.seed,
                             fwd.dropout_ratio).to(self.act_store_dtype)
