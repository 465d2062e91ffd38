"""Forward-unit base (counterpart of ``znicz_tpu/ops/nn_units.py`` and the
precision rules of ``znicz_tpu/accelerated_units.py``).

A forward unit here is an ``nn.Module`` built from one layer entry of
a bundle manifest: its per-sample input shape, its config and the
compute dtype the net trained under.  Its parameters carry the
bundle's names (``weights``, ``bias``, …) and stay float32 in every
precision mode, as in the reference.

Two precision rules carry over from the reference's XLA path:

- :meth:`Forward.mxu_dot` — in bf16 mode the product's operands are
  rounded to bf16 and the result is f32 (the reference's ``jnp.dot``
  with ``preferred_element_type=float32``).  Here that is an f32
  product of bf16-rounded operands; with TF32 off
  (:mod:`znicz_tpu_torch.backends`) it is exact up to summation order.
- :attr:`Forward.act_store_dtype` — activations between layers are
  stored in bf16 in bf16 mode and in f32 otherwise.  The port has no
  host-only oracle device: the CPU runs the same arithmetic as the
  card, through the kernels' plain versions.

Backward units and the training machinery arrive with the training
slice.
"""

from __future__ import annotations

import torch
from torch import nn

from znicz_tpu_torch import backends  # noqa: F401 — no TF32 in f32 products


class Forward(nn.Module):
    """Base forward unit over a batch of samples of ``input_shape``."""

    #: parameter attributes an exported bundle carries for this unit
    EXPORT_PARAMS: tuple = ("weights", "bias")
    #: manifest config keys that only shaped the random initial fill
    INIT_ONLY = frozenset(("weights_filling", "weights_stddev",
                           "bias_filling", "bias_stddev"))

    def __init__(self, input_shape, compute_dtype: torch.dtype,
                 include_bias: bool = True, **init_config) -> None:
        unknown = set(init_config) - self.INIT_ONLY
        if unknown:
            raise TypeError(f"{type(self).__name__}: unsupported config "
                            f"{sorted(unknown)}")
        super().__init__()
        self.input_shape = tuple(int(n) for n in input_shape)
        self.compute_dtype = compute_dtype
        self.include_bias = bool(include_bias)

    # -- geometry and parameters ------------------------------------------
    def param_shapes(self) -> dict[str, tuple]:
        """Shape of every parameter this unit needs, by attribute."""
        raise NotImplementedError

    @property
    def output_shape(self) -> tuple:
        """Per-sample output shape."""
        return self.input_shape

    def load_params(self, arrays: dict[str, torch.Tensor]) -> None:
        """Adopt a bundle's parameters (``attr → tensor``).  A missing
        or mis-shaped parameter raises: serving a random or truncated
        substitute would be silently wrong."""
        for attr, shape in self.param_shapes().items():
            value = arrays.get(attr)
            if value is None:
                raise ValueError(f"{type(self).__name__}: parameter "
                                 f"'{attr}' missing from the bundle")
            if tuple(value.shape) != tuple(shape):
                raise ValueError(
                    f"{type(self).__name__} {attr}: bundle shape "
                    f"{tuple(value.shape)} != expected {tuple(shape)}")
            setattr(self, attr, nn.Parameter(
                value.detach().to(torch.float32), requires_grad=False))

    # -- precision --------------------------------------------------------
    @property
    def mxu_dtype(self) -> torch.dtype | None:
        """Product operand dtype: bf16 in bf16 mode, else None (full
        f32 products)."""
        return torch.bfloat16 if self.compute_dtype == torch.bfloat16 \
            else None

    @property
    def act_store_dtype(self) -> torch.dtype:
        """Storage dtype of activations: bf16 in bf16 mode, else f32."""
        return torch.bfloat16 if self.compute_dtype == torch.bfloat16 \
            else torch.float32

    @property
    def output_store_dtype(self) -> torch.dtype:
        return self.act_store_dtype

    def mxu_dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with f32 result; operands rounded to bf16 first in
        bf16 mode."""
        dt = self.mxu_dtype
        if dt is not None:
            a, b = a.to(dt), b.to(dt)
        return torch.matmul(a.float(), b.float())
