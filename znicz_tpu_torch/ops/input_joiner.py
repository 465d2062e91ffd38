"""InputJoiner (port of ``znicz_tpu/ops/input_joiner.py``).

Concatenates several units' outputs into one ``(batch, Σ features)``
tensor, each flattened per sample: one ``torch.cat``.

Wiring: ``join.link_inputs(a, b, ...)`` aliases each source's
``output`` (a live link, read at every step, as a forward's output is a
new tensor each step); a paired :class:`GDInputJoiner` splits the error
back by the recorded ``offsets`` into ``err_inputs``, one a source.
Standalone, ``InputJoiner(input_shapes=[...])`` joins the tensors it is
called with.  On the numpy oracle both run the reference's numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.mutable import LinkableAttribute
from znicz_tpu_torch.ops.nn_units import (Forward, WeightlessGradientUnit,
                                          as_numpy, stored_f32)


class InputJoiner(Forward):
    """The joined sample of its inputs (weightless)."""

    EXPORT_PARAMS = ()

    def __init__(self, input_shapes=None,
                 compute_dtype: torch.dtype | None = None,
                 **kwargs) -> None:
        super().__init__(None, compute_dtype, **kwargs)
        #: the per-sample shape of each input
        self.input_shapes = (None if input_shapes is None
                             else [tuple(int(n) for n in s)
                                   for s in input_shapes])
        self._input_links: list[LinkableAttribute] = []
        self.offsets: list[int] = []
        if self.input_shapes:
            self._set_offsets()

    def link_inputs(self, *units) -> "InputJoiner":
        for unit in units:
            self._input_links.append(LinkableAttribute(unit, "output",
                                                       two_way=False))
        return self

    @property
    def inputs(self) -> list:
        """This step's input values, in link order."""
        return [link.get() for link in self._input_links]

    def _set_offsets(self) -> None:
        sizes = [int(np.prod(s)) for s in self.input_shapes]
        self.offsets = [int(o) for o in np.cumsum([0] + sizes)]
        self.input_shape = (self.offsets[-1],)

    def initialize(self, device=None, **kwargs) -> None:
        if self._input_links:
            shapes = []
            for link in self._input_links:
                src = link.source
                if not src.is_initialized:
                    raise AttributeError(f"{self}: input source {src} not "
                                         f"initialized yet")
                shapes.append(tuple(src.output_shape
                                    if isinstance(src, Forward)
                                    else src.sample_shape))
            self.input_shapes = shapes
        if not self.input_shapes:
            raise AttributeError(f"{self}: no inputs linked")
        self._set_offsets()
        super().initialize(device=device, **kwargs)

    def region_vectors(self) -> list[Vector]:
        # the inputs are invisible to the default scan of attributes
        vecs = super().region_vectors()
        seen = {id(v) for v in vecs}
        for value in self.inputs:
            if isinstance(value, Vector) and value and id(value) not in seen:
                vecs.append(value)
        return vecs

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        n = xs[0].shape[0]
        return torch.cat([x.reshape(n, -1) for x in xs], dim=1).to(
            self.output_store_dtype)

    def device_run(self) -> None:
        self.output = self(*self.inputs)

    def numpy_run(self) -> None:
        parts = [as_numpy(v) for v in self.inputs]
        n = parts[0].shape[0]
        self.output = stored_f32(np.concatenate(
            [p.reshape(n, -1) for p in parts], axis=1))


class GDInputJoiner(WeightlessGradientUnit):
    """Split the joined error back into one piece a source
    (``err_inputs[i]`` matches ``forward_unit.inputs[i]``)."""

    MATCHES = (InputJoiner,)
    NEEDS_AUTOGRAD = False

    def __init__(self, forward_unit: InputJoiner, *args, **kwargs) -> None:
        super().__init__(forward_unit, *args, **kwargs)
        self.err_inputs: list = []

    def _pieces(self, err):
        fwd = self.forward_unit
        n = err.shape[0]
        return [err[:, lo:hi].reshape((n, *shape))
                for shape, lo, hi in zip(fwd.input_shapes, fwd.offsets,
                                         fwd.offsets[1:])]

    @torch.no_grad()
    def backprop(self, x, err_output: torch.Tensor, y=None) -> list:
        """The error of each source (the activation storage dtype)."""
        return [p.to(self.act_store_dtype).contiguous()
                for p in self._pieces(err_output)]

    def device_run(self) -> None:
        self.err_inputs = self.backprop(None, self.err_output)

    def numpy_backprop(self, x, err_output, y=None) -> list:
        return [stored_f32(p) for p in self._pieces(err_output)]

    def numpy_run(self) -> None:
        self.err_inputs = self.numpy_backprop(None,
                                              as_numpy(self.err_output))
