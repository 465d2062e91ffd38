"""Workflow: a container of units with a scheduler and a lifecycle (port
of ``znicz_tpu/workflow.py``).

The scheduler is the reference's deterministic worklist: no threads,
the same order of firing on every run.  The device overlaps with the
host through the CUDA stream, and the hot chain of a training step runs
as one region (:mod:`znicz_tpu_torch.accelerated_units`).
:meth:`Workflow.generate_graph` writes Graphviz DOT, as the
reference's does.
"""

from __future__ import annotations

import time
from collections import deque

from znicz_tpu_torch.mutable import Bool
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.units import Container, EndPoint, StartPoint, Unit


class Workflow(Container):
    """A directed graph of units run from ``start_point``.

    Lifecycle: build the units and link them in ``__init__`` (or after),
    then :meth:`initialize` (several passes: a unit whose linked
    attributes are not there yet defers), then :meth:`run` — the
    scheduler fires units until :attr:`end_point` runs or :meth:`stop`
    is called.
    """

    def __init__(self, workflow: "Workflow | None" = None,
                 name: str | None = None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.start_point = StartPoint(self, name="start_point")
        self.end_point = EndPoint(self, name="end_point")
        self.stopped = Bool(False)
        self._finished = False
        self._max_fires: int | None = None  # a runaway guard for tests
        #: step-boundary hooks, fired by the decision unit once a step
        #: (once a chunk under ``run_chunked``)
        self._step_hooks: list = []

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, **kwargs) -> None:
        """Initialize every unit, retrying those whose linked attributes
        come from units initialized later; a pass that makes no progress
        is a deadlock, reported with the first stuck unit."""
        pending = list(self.units)
        passes = 0
        while pending:
            passes += 1
            deferred: list[tuple[Unit, AttributeError]] = []
            progress = False
            for unit in pending:
                if unit.is_initialized:
                    continue
                try:
                    unit.initialize(**kwargs)
                    unit._initialized = True
                    progress = True
                except AttributeError as exc:
                    # a base class may have set the flag before the
                    # subclass raised: the loop decides
                    unit._initialized = False
                    deferred.append((unit, exc))
            if not deferred:
                break
            if not progress:
                unit, exc = deferred[0]
                raise RuntimeError(
                    f"workflow '{self.name}' initialize deadlock after "
                    f"{passes} passes; first stuck unit: {unit} "
                    f"({exc})") from exc
            pending = [u for u, _ in deferred]
        self._initialized = True

    def _begin_run(self) -> deque:
        if not self.is_initialized:
            raise RuntimeError(f"workflow '{self.name}' not initialized")
        self.run_started_at = time.time()
        if _metrics.enabled():
            _metrics.workflow_runs(self.name).inc()
        self._finished = False
        self.stopped.value = False
        self.start_point.reset_links()
        return deque([self.start_point])

    def _drain(self, queue: deque, pause_at: Unit | None = None,
               honor_stop: bool = True) -> int:
        """Fire units from ``queue`` until it empties or the end point
        fires (or, with ``honor_stop``, :meth:`stop` is called).  A unit
        under ``gate_block`` drops the signal; one under ``gate_skip``
        passes it on without running.  A unit whose gate opens is queued,
        but ``pause_at``: the drain ends without it (one pass round a
        loop).  Returns the number of units taken from the queue."""
        fires = 0
        while queue and not self._finished \
                and not (honor_stop and self.stopped):
            unit = queue.popleft()
            if unit.gate_block:
                continue
            if not unit.gate_skip:
                unit._fire()
                if self._finished or (honor_stop and self.stopped):
                    break
            for dst in list(unit.links_to):
                if dst.open_gate(unit):
                    dst.reset_links()
                    if dst is not pause_at:
                        queue.append(dst)
            fires += 1
            if self._max_fires is not None and fires > self._max_fires:
                raise RuntimeError(
                    f"workflow '{self.name}' exceeded max_fires="
                    f"{self._max_fires} (runaway loop?)")
        return fires

    def run(self) -> None:
        """Fire units from ``start_point`` until the end."""
        queue = self._begin_run()
        with _tracing.TRACER.span(f"workflow:{self.name}", cat="workflow"):
            self._drain(queue)
        self.on_workflow_finished()

    def on_end_point(self) -> None:
        self._finished = True

    def stop(self) -> None:
        self.stopped.value = True
        for unit in self.units:
            unit.stop()

    # -- step-boundary hooks ----------------------------------------------------
    def add_step_hook(self, fn) -> None:
        if fn not in self._step_hooks:
            self._step_hooks.append(fn)

    def remove_step_hook(self, fn) -> None:
        if fn in self._step_hooks:
            self._step_hooks.remove(fn)

    def on_step_boundary(self) -> None:
        """Called by the decision unit after each step's bookkeeping."""
        for fn in list(self._step_hooks):
            fn()

    def on_workflow_finished(self) -> None:
        """After the scheduler drains: log the slowest units."""
        rows = sorted((u for u in self.units if u.run_count),
                      key=lambda u: u.run_time_total, reverse=True)[:5]
        if rows:
            self.debug("slowest units: %s", ", ".join(
                f"{u.name}: {u.run_time_total:.3f}s/{u.run_count}x"
                for u in rows))

    # -- snapshot protocol ---------------------------------------------------------
    def state_dict(self, allow_collective: bool = False) -> dict:
        """Every unit's state that is not empty, by unit name, and the
        default generator's (so a resume goes on as the run would)."""
        from znicz_tpu_torch.utils import prng
        state: dict = {"__units__": {}, "__prng__": prng.get().get_state()}
        for unit in self.units:
            unit_state = unit.state_dict(allow_collective=allow_collective)
            if unit_state:
                state["__units__"][unit.name] = unit_state
        return state

    def load_state(self, state: dict) -> None:
        from znicz_tpu_torch.utils import prng
        by_name = state.get("__units__", {})
        for unit in self.units:
            unit_state = by_name.get(unit.name)
            if unit_state:
                unit.load_state(unit_state)
        if "__prng__" in state:
            prng.get().set_state(state["__prng__"])

    # -- introspection ------------------------------------------------------------
    def generate_graph(self) -> str:
        """Graphviz DOT of the control-flow graph."""
        lines = [f'digraph "{self.name}" {{', "  rankdir=TB;"]
        ids = {unit: f"u{i}" for i, unit in enumerate(self.units)}
        for unit, uid in ids.items():
            lines.append(
                f'  {uid} [label="{unit.name}\\n{type(unit).__name__}"];')
        for unit, uid in ids.items():
            for dst in unit.links_to:
                if dst in ids:
                    lines.append(f"  {uid} -> {ids[dst]};")
        lines.append("}")
        return "\n".join(lines)
