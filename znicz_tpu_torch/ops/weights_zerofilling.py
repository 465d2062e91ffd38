"""ZeroFiller: force masked weight entries to zero after each update,
for sparsity experiments (port of ``znicz_tpu/ops/weights_zerofilling.py``).

Not a chain layer: a side unit after the backward chain, its
``target_weights`` linked to a forward unit's ``weights``.  It
multiplies them by ``zero_mask`` in place (``mul_``), so the tensor a
captured step reads and writes keeps its address.  The mask is a
:class:`~znicz_tpu_torch.memory.Vector` (ones until the caller writes
it), so a host write reaches the device before the next step and the
mask goes into a snapshot.  In a ``StandardWorkflow`` it is linked
after the last backward unit, and the training step's region runs it
after the update (on the card inside the step's CUDA graph; on the
numpy oracle the graph fires it after that unit)::

    zf = ZeroFiller(wf)
    zf.link_attrs(wf.forwards[0], ("target_weights", "weights"))
    zf.link_from(wf.gds[0])

On the numpy oracle it runs the reference's numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.ops.nn_units import as_numpy


class ZeroFiller(AcceleratedUnit):
    """``target_weights *= zero_mask``, in place."""

    WRITES = ("target_weights",)

    def __init__(self, workflow=None, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.target_weights = None            # linked from a forward
        self.zero_mask = Vector(name=f"{self.name}.zero_mask")

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        target = self.target_weights
        if target is None:
            raise AttributeError(f"{self}: target_weights not linked")
        if not self.zero_mask:
            self.zero_mask.reset(np.ones(tuple(target.shape),
                                         dtype=np.float32))
        self.init_vectors(self.zero_mask)

    def host_run(self) -> None:
        # a host write of the mask reaches the device (in a region, the
        # region unmaps it before each step)
        self.zero_mask.unmap()

    @torch.no_grad()
    def device_run(self) -> None:
        self.target_weights.mul_(self.zero_mask.devmem)

    def numpy_run(self) -> None:
        as_numpy(self.target_weights)[...] *= self.zero_mask.mem
