"""A sample's own training loop with its hot units as one region: the
shape of the reference's custom ``AcceleratedWorkflow`` samples
(``mnist_rbm``, ``kohonen``), which have no backward chain, so
``StandardWorkflow`` does not apply.

.. code-block:: text

    start → repeater → loader (host pick) → <name>_region → decision ─→ repeater
                                                              └─(complete)→ end

A subclass builds its loader, its hot units (each linked from the one
before, the first from the loader) and its decision, then calls
:meth:`LoopWorkflow.link_loop`.  :meth:`LoopWorkflow.initialize` puts a
:class:`~znicz_tpu_torch.accelerated_units.RegionUnit` over
:meth:`LoopWorkflow.hot_chain_units` in the chain's place (on the card
a CUDA graph captured once per key and replayed, on the CPU the same
members eagerly), except on the numpy oracle, whose units run one by
one.  :meth:`LoopWorkflow.run` is the scheduler's loop, as in the
reference; :meth:`LoopWorkflow.step` is one pass round it (with a
``mark``, the region's members eagerly, for per-unit timing).  There is
no ``run_chunked``: the launcher trains such a workflow with ``run()``
whatever ``--chunk`` says, as the reference's does.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

from znicz_tpu_torch.accelerated_units import AcceleratedWorkflow, RegionUnit
from znicz_tpu_torch.mutable import Bool
from znicz_tpu_torch.units import Repeater


class LoopWorkflow(AcceleratedWorkflow):
    """A custom training loop whose hot units run as one region."""

    #: the region unit's name
    REGION_NAME = "region"

    def __init__(self, workflow=None, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.repeater = Repeater(self, name="repeater")
        self.loader = None
        self.decision = None
        self._region_unit: RegionUnit | None = None

    def hot_chain_units(self) -> list:
        """The per-minibatch hot chain in the region's order, the loader
        first."""
        raise NotImplementedError

    def link_loop(self) -> None:
        """The loop's control flow round the hot chain."""
        decision = self.decision
        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        prev = self.loader
        for unit in self.hot_chain_units()[1:]:
            unit.link_from(prev)
            prev = unit
        decision.link_from(prev)
        self.repeater.link_from(decision)
        self.repeater.gate_block = Bool._derived(lambda: decision.complete)
        self.end_point.link_from(decision)
        self.end_point.gate_block = Bool._derived(
            lambda: not decision.complete)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        if not self.device.is_host_only and self._region_unit is None:
            members = self.hot_chain_units()
            region = RegionUnit(self, members, name=self.REGION_NAME)
            region.initialize(device=self.device)
            region._initialized = True
            members[1].unlink_from(self.loader)
            self.decision.unlink_from(members[-1])
            region.link_from(self.loader)
            self.decision.link_from(region)
            self._region_unit = region

    @property
    def region(self):
        """The step's :class:`JitRegion` (None on the numpy oracle)."""
        return None if self._region_unit is None \
            else self._region_unit.region

    def step(self, mark: Callable[[str], None] | None = None) -> None:
        """One pass round the loop: the loader's pick, the region (or on
        the oracle the hot units one by one), the decision's
        bookkeeping.  ``mark`` makes the region run its members eagerly
        and is called with each member's name after its work."""
        if not self.is_initialized:
            raise RuntimeError(f"workflow '{self.name}' not initialized")
        self._finished = False
        region = self.region
        if region is not None:
            region.mark = mark
        try:
            self._drain(deque(self.repeater.links_to),
                        pause_at=self.repeater, honor_stop=False)
        finally:
            if region is not None:
                region.mark = None
