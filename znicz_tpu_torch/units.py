"""Dataflow units: the nodes of the workflow graph (port of
``znicz_tpu/units.py``).

- **control links** (``b.link_from(a)``): b may fire once a has fired;
  a unit with several incoming links waits for all of them
  (:class:`Repeater` waits for any, which is what closes a training
  loop);
- **attribute links** (``b.link_attrs(a, ("input", "output"))``):
  ``b.input`` is a live alias of ``a.output`` — the data plane;
- **gates**: ``gate_block`` (do not run, do not propagate) and
  ``gate_skip`` (do not run, but propagate), both
  :class:`~znicz_tpu_torch.mutable.Bool`, so other units flip them live.

The graph is the host's control plane between device steps.  The hot
chain of a training step runs as one region
(:mod:`znicz_tpu_torch.accelerated_units`): on the card a CUDA graph
captured once per static key and replayed.

A unit may also be an ``nn.Module`` (the op units are): both classes
override ``__setattr__`` and ``__getattr__``.  :class:`Unit` resolves
its attribute links first and hands every other name to the next class
in the MRO, so ``nn.Module`` still registers parameters and buffers and
finds them.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Iterable

import numpy as np

from znicz_tpu_torch.mutable import Bool, LinkableAttribute
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.utils.logger import Logger

if TYPE_CHECKING:  # pragma: no cover
    from znicz_tpu_torch.workflow import Workflow


class Unit(Logger):
    """A node in the dataflow graph.

    Subclasses override :meth:`initialize` (allocate state once the
    graph is wired) and :meth:`run` (one firing).  ``initialize`` may
    raise :class:`AttributeError` while a linked attribute is not yet
    there; the workflow retries it after the others.
    """

    #: extra attributes a snapshot carries beside the unit's Vectors
    SNAPSHOT_ATTRS: tuple = ()

    def __init__(self, workflow: "Workflow | None" = None,
                 name: str | None = None, **kwargs) -> None:
        # the link table must exist before any attribute write resolves
        object.__setattr__(self, "_linked_attrs", {})
        super().__init__(**kwargs)
        self.name = name or type(self).__name__
        self.links_from: dict[Unit, bool] = {}
        self.links_to: dict[Unit, bool] = {}
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._initialized = False
        self.run_count = 0
        self.run_time_total = 0.0
        self._workflow: "Workflow | None" = None
        if workflow is not None:
            workflow.add_ref(self)

    # -- attribute links (data plane) -----------------------------------
    def __setattr__(self, name: str, value) -> None:
        link = self.__dict__["_linked_attrs"].get(name)
        if link is not None:
            link.set(value)
            return
        super().__setattr__(name, value)

    def __getattr__(self, name: str):
        # only reached when the normal lookup fails
        links = self.__dict__.get("_linked_attrs")
        if links is not None and name in links:
            return links[name].get()
        parent = getattr(super(), "__getattr__", None)
        if parent is not None:  # nn.Module's parameters and buffers
            return parent(name)
        raise AttributeError(
            f"{type(self).__name__} '{self.__dict__.get('name', '?')}' "
            f"has no attribute '{name}'")

    def link_attrs(self, other: "Unit", *pairs: "str | tuple[str, str]",
                   two_way: bool = True) -> "Unit":
        """Alias attributes of ``other`` into this unit.  Each pair is a
        name (the same on both sides) or ``(dst_name, src_name)``:
        ``self.dst_name`` aliases ``other.src_name``."""
        for pair in pairs:
            dst, src = (pair, pair) if isinstance(pair, str) else pair
            self.__dict__.pop(dst, None)  # the alias must win lookups
            self._linked_attrs[dst] = LinkableAttribute(other, src, two_way)
        return self

    # -- control links ----------------------------------------------------
    def link_from(self, *units: "Unit") -> "Unit":
        for unit in units:
            self.links_from[unit] = False
            unit.links_to[self] = False
        return self

    def unlink_from(self, *units: "Unit") -> None:
        for unit in units:
            self.links_from.pop(unit, None)
            unit.links_to.pop(self, None)

    def open_gate(self, src: "Unit") -> bool:
        """Record that ``src`` fired; True when this unit may fire (all
        incoming links fired: a barrier join)."""
        if src in self.links_from:
            self.links_from[src] = True
        return all(self.links_from.values())

    def reset_links(self) -> None:
        for unit in self.links_from:
            self.links_from[unit] = False

    # -- lifecycle ----------------------------------------------------------
    @property
    def workflow(self) -> "Workflow | None":
        return self._workflow

    @property
    def is_initialized(self) -> bool:
        return self._initialized

    def initialize(self, **kwargs) -> None:
        """Allocate state.  May raise AttributeError to defer."""
        self._initialized = True

    def run(self) -> None:
        """One firing of the unit."""

    def stop(self) -> None:
        """Called when the workflow stops."""

    # -- snapshot protocol --------------------------------------------------
    def state_dict(self, allow_collective: bool = False) -> dict:
        """The unit's state as plain host data: each owned
        :class:`~znicz_tpu_torch.memory.Vector` read back to the host,
        and :attr:`SNAPSHOT_ATTRS`."""
        from znicz_tpu_torch.memory import Vector  # avoids an import cycle
        out: dict = {}
        for name, val in self.__dict__.items():
            if isinstance(val, Vector) and val:
                val.map_read()
                out[name] = np.array(val.mem, copy=True)
        for name in self.SNAPSHOT_ATTRS:
            out[name] = getattr(self, name)
        return out

    def load_state(self, state: dict) -> None:
        from znicz_tpu_torch.memory import Vector
        for name, val in state.items():
            cur = self.__dict__.get(name)
            if isinstance(cur, Vector):
                cur.assign(np.array(val, copy=True))
            else:
                setattr(self, name, val)

    # engine hook: the workflow's scheduler fires a unit through it
    def _fire(self) -> None:
        start = time.perf_counter()
        if _metrics.enabled():
            with _tracing.TRACER.span(self.name, cat="unit",
                                      kind=type(self).__name__):
                self.run()
            elapsed = time.perf_counter() - start
            _metrics.unit_run_seconds(self.name).observe(elapsed)
        else:
            self.run()
            elapsed = time.perf_counter() - start
        self.run_time_total += elapsed
        self.run_count += 1

    def __repr__(self) -> str:
        return f"<{type(self).__name__} '{self.name}'>"


class TrivialUnit(Unit):
    """A unit that does nothing (a join or fan-out point)."""


class Repeater(TrivialUnit):
    """Opens its gate on ANY incoming link: the unit that closes a
    training loop (start → repeater ← decision)."""

    def open_gate(self, src: Unit) -> bool:
        if src in self.links_from:
            self.links_from[src] = True
        return any(self.links_from.values())


class StartPoint(TrivialUnit):
    """The workflow's entry node."""


class EndPoint(TrivialUnit):
    """The workflow's exit node; firing it ends the run."""

    def run(self) -> None:
        wf = self.workflow
        if wf is not None:
            wf.on_end_point()


class Container(Unit):
    """A unit that owns other units."""

    def __init__(self, workflow: "Workflow | None" = None,
                 name: str | None = None, **kwargs) -> None:
        object.__setattr__(self, "units", [])
        super().__init__(workflow, name=name, **kwargs)

    def add_ref(self, unit: Unit) -> None:
        if unit is self:
            raise ValueError("a container cannot contain itself")
        taken = {u.name for u in self.units}
        if unit.name in taken:  # unique names: they key the snapshot
            i = 2
            while f"{unit.name}_{i}" in taken:
                i += 1
            unit.name = f"{unit.name}_{i}"
        self.units.append(unit)
        unit._workflow = self  # type: ignore[assignment]

    def __iter__(self) -> "Iterable[Unit]":
        return iter(self.units)

    def __len__(self) -> int:
        return len(self.units)
