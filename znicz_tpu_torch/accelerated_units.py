"""Accelerated units and the region engine (port of
``znicz_tpu/accelerated_units.py``).

- :class:`AcceleratedUnit` is a unit with a device and the precision
  rules (``compute_dtype``, ``mxu_dtype``, ``act_store_dtype``,
  ``mxu_dot``).  Its :meth:`~AcceleratedUnit.run` is ``host_run`` (per-step
  host bookkeeping) then ``device_run`` (the device work), and only
  ``host_run`` when the unit belongs to a region, which runs its device
  work.
- :class:`JitRegion` runs an ordered chain of units as one step.  Its
  counterpart of the reference's cache of XLA programs is a cache of
  CUDA graphs, one per static key: the members' ``region_key()``, their
  gate skips and the minibatch class.  The first step of a key runs the
  members eagerly on a side stream (the warm-up: autograd, cuBLAS and
  cuDNN set themselves up, and cuDNN picks its algorithms, outside the
  capture), then captures the same chain into a graph; every later step
  of that key is one replay.  On the CPU the region runs its members
  eagerly through the same code: the counterpart of the reference's
  XLA region on its CPU backend.  So does a step with a ``mark`` (per-unit
  timing).
- :meth:`JitRegion.run_chunk` runs n steps with no host bookkeeping and
  no sync between them: n replays of one step's graph.
- :class:`RegionUnit` puts a region into the workflow's graph and
  :class:`AcceleratedWorkflow` owns the device.

A captured graph computes the wrong thing silently where a step's
input is a host value, so the region's contract is the reference's:

- a member's ``device_run`` is device work only: no ``.item()``, no
  host branch on data, no host value that changes from step to step
  (the loader's cursor, the valid count of a short minibatch, a dropout
  seed: each is device state the step advances, or part of the key);
- state that outlives a step is written in place (``copy_``, ``add_``,
  a :class:`~znicz_tpu_torch.memory.Vector` write), never rebound: the
  graph reads and writes the addresses it captured;
- per-step host bookkeeping goes in ``host_run``, outside the region,
  or in ``sync_host_state``, which the region calls before every step.

A replay runs no Python, so the kernels' launch counters
(:mod:`~znicz_tpu_torch.ops.launch_counts`) take what a capture counted
once a replay; and the attributes a capture bound (each unit's
``output``, ``err_input``…) are bound again before each replay, since
another key's graph may have bound its own since.  Every other device
tensor a capture left bound must still be bound at each replay: a
replay that finds one rebound raises, naming it, rather than compute on
the tensor the graph captured.  There is no fallback: a capture that
fails raises, naming the unit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from znicz_tpu_torch.backends import Device
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.units import Unit
from znicz_tpu_torch.utils.logger import Logger
from znicz_tpu_torch.workflow import Workflow


def precision_dtypes(compute_dtype: torch.dtype
                     ) -> tuple[torch.dtype | None, torch.dtype]:
    """``(product operand dtype or None, storage dtype)`` of activations,
    errors and momentum in one precision mode."""
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16, torch.bfloat16
    return None, torch.float32


class AcceleratedUnit(Unit):
    """A unit with a device, the precision rules and the region
    protocol."""

    #: True for a unit whose device work needs autograd on (a backward
    #: unit): a region step runs with gradients enabled iff it runs one
    NEEDS_AUTOGRAD = False

    def __init__(self, workflow=None, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.device: Device | None = None
        self._in_region = False
        self.compute_dtype = torch.float32

    # -- lifecycle ------------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        if device is None and isinstance(self.workflow, AcceleratedWorkflow):
            device = self.workflow.device
        if device is None:
            raise ValueError(f"{self}: no device supplied")
        self.device = Device.create(device)
        super().initialize(**kwargs)

    @property
    def torch_device(self) -> torch.device:
        return self.device.torch_device

    # -- precision --------------------------------------------------------------
    @property
    def mxu_dtype(self) -> torch.dtype | None:
        """Product operand dtype: bf16 in bf16 mode, else None (full f32
        products)."""
        return precision_dtypes(self.compute_dtype)[0]

    @property
    def act_store_dtype(self) -> torch.dtype:
        """Storage dtype of activations and errors: bf16 in bf16 mode,
        else f32 (parameters, gradients and loss sums stay f32)."""
        return precision_dtypes(self.compute_dtype)[1]

    def mxu_dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with an f32 result, the operands rounded to bf16
        first in bf16 mode (the reference's ``jnp.dot`` with
        ``preferred_element_type=float32``; with TF32 off an f32
        product of bf16-rounded operands, exact up to summation
        order)."""
        dt = self.mxu_dtype
        if dt is not None:
            a, b = a.to(dt), b.to(dt)
        return torch.matmul(a.float(), b.float())

    # -- vectors ------------------------------------------------------------------
    def init_vectors(self, *vectors: Vector) -> None:
        """Attach ``vectors`` to the unit's device."""
        for vec in vectors:
            if vec:
                vec.initialize(self.device)

    def unmap_vectors(self, *vectors: Vector) -> None:
        for vec in vectors:
            if vec:
                vec.unmap()

    def vector(self, name: str) -> Vector:
        """The attribute ``name`` as a :class:`Vector`: itself when it is
        one, else a Vector over the tensor it holds (the same storage, so
        ``map_write``/``unmap`` write the tensor in place)."""
        value = getattr(self, name)
        if isinstance(value, Vector):
            return value
        if not isinstance(value, torch.Tensor):
            raise TypeError(f"{self}.{name} holds {type(value).__name__}, "
                            f"not a tensor")
        cache = self.__dict__.setdefault("_vector_views", {})
        vec = cache.get(name)
        if vec is None or vec._devmem.data_ptr() != value.data_ptr() \
                or tuple(vec.shape) != tuple(value.shape):
            vec = cache[name] = Vector.adopt(value, f"{self.name}.{name}")
        return vec

    # -- execution ------------------------------------------------------------------
    def host_run(self) -> None:
        """Per-step host bookkeeping (runs even when a region owns the
        unit's device work)."""

    def sync_host_state(self) -> None:
        """Called by the region before each of its steps, outside any
        capture: write host-held state the step reads into its device
        tensors (in place)."""

    def device_run(self) -> None:
        """The unit's device work for one step."""
        raise NotImplementedError(f"{type(self).__name__}.device_run")

    def run(self) -> None:
        self.host_run()
        if self._in_region:
            return  # the region runs the device work
        self.device_run()

    # -- region protocol ---------------------------------------------------------
    def region_vectors(self) -> list[Vector]:
        """Vectors the unit's device work touches: its own, then those
        its linked attributes resolve to.  The region unmaps them before
        each step, so a host write reaches the device first."""
        found: dict[int, Vector] = {}
        for name in sorted(self.__dict__):
            val = self.__dict__[name]
            if isinstance(val, Vector) and val:
                found.setdefault(id(val), val)
        for name in sorted(self._linked_attrs):
            try:
                val = self._linked_attrs[name].get()
            except AttributeError:
                continue
            if isinstance(val, Vector) and val:
                found.setdefault(id(val), val)
        return list(found.values())

    def region_key(self) -> tuple:
        """Hashable static flags; the region captures a graph for each
        value."""
        return ()


class _Graph:
    """One captured step: the graph, the launches its capture counted,
    the attributes it bound (the step's outputs, bound again before each
    replay) and the device tensors it read and wrote in place (which
    must still be bound at each replay)."""

    __slots__ = ("graph", "launches", "outputs", "fixed")

    def __init__(self, graph, launches, outputs, fixed) -> None:
        self.graph = graph
        self.launches = launches
        self.outputs = outputs
        self.fixed = fixed


def _bindings(units) -> dict:
    """Every tensor attribute of the units (an ``nn.Module``'s parameters
    and buffers too) and each Vector's device tensor, as
    ``{(id(owner), name): (owner, name, tensor, label)}``."""
    out = {}
    for unit in units:
        owners = [unit.__dict__, unit.__dict__.get("_parameters", {}),
                  unit.__dict__.get("_buffers", {})]
        for table in owners:
            for name, value in list(table.items()):
                if isinstance(value, torch.Tensor):
                    owner, attr = table, name
                elif isinstance(value, Vector) and value._devmem is not None:
                    owner, attr, value = value, "_devmem", value._devmem
                else:
                    continue
                out[id(owner), attr] = (owner, attr, value,
                                        f"{unit.name}.{name}")
    return out


def _split(warm: dict, captured: dict, device) -> tuple[list, list]:
    """``(outputs, fixed)`` of a capture from the bindings after the
    warm-up and after the capture: the attributes whose tensor the
    capture replaced, as ``(owner, name, tensor)``, and the tensors on
    ``device`` it left bound, as ``(key, label, owner, name,
    data_ptr)``."""
    outputs, fixed = [], []
    for key, (owner, name, value, label) in captured.items():
        was = warm.get(key)
        if was is None or was[2] is not value:
            outputs.append((owner, name, value))
        elif value.device.type == device.type:
            fixed.append((key, label, owner, name, value.data_ptr()))
    return outputs, fixed


def _get(owner, name):
    return owner.get(name) if isinstance(owner, dict) \
        else getattr(owner, name, None)


def _rebind(bindings) -> None:
    for owner, name, value in bindings:
        if isinstance(owner, dict):
            owner[name] = value
        else:
            setattr(owner, name, value)


class JitRegion(Logger):
    """Runs an ordered chain of units as one step: replays of CUDA graphs
    captured once per static key on the card, the members in order
    elsewhere."""

    def __init__(self, name: str, units: Sequence[AcceleratedUnit],
                 device: Device) -> None:
        super().__init__()
        self.name = name
        self.units = list(units)
        self.device = device
        for unit in self.units:
            unit._in_region = True
        self._vectors: list[Vector] | None = None
        self._cache: dict[tuple, _Graph] = {}
        #: the attributes any of the graphs binds, as ``(id(owner), name)``
        self._outputs: set = set()
        #: ``mark(unit_name)``, when set, is called after each member's
        #: work and the step runs eagerly (per-unit timing)
        self.mark = None

    @property
    def graphed(self) -> bool:
        """True when this step replays a captured graph: on the card,
        with no ``mark``."""
        return self.device.type == "cuda" and self.mark is None

    @property
    def captures(self) -> int:
        """Graphs captured so far (one per key seen)."""
        return len(self._cache)

    def _collect_vectors(self) -> list[Vector]:
        seen: dict[int, Vector] = {}
        for unit in self.units:
            for vec in unit.region_vectors():
                seen.setdefault(id(vec), vec)
        return list(seen.values())

    def _prepare(self) -> tuple[tuple, tuple]:
        """Host writes to the device, then ``(key, skips)``."""
        if self._vectors is None:
            self._vectors = self._collect_vectors()
        for vec in self._vectors:
            vec.unmap()
        skips = tuple(bool(unit.gate_skip) for unit in self.units)
        for unit, skip in zip(self.units, skips):
            if not skip:
                unit.sync_host_state()
        key = tuple(unit.region_key() for unit in self.units) + (skips,)
        return key, skips

    def _run_members(self, skips, capture: bool = False) -> None:
        grad = any(unit.NEEDS_AUTOGRAD and not skip
                   for unit, skip in zip(self.units, skips))
        mark = self.mark
        with torch.set_grad_enabled(grad):
            for unit, skip in zip(self.units, skips):
                if skip:
                    continue
                if not capture:
                    with _tracing.TRACER.span(unit.name, cat="unit"):
                        unit.device_run()
                    if mark is not None:
                        mark(unit.name)
                    continue
                try:
                    unit.device_run()
                except Exception as exc:
                    raise RuntimeError(
                        f"region '{self.name}': the CUDA-graph capture "
                        f"failed in unit '{unit.name}' "
                        f"({type(unit).__name__}): {exc}") from exc

    def _capture(self, key, skips) -> _Graph:
        """This step eagerly on a side stream (the warm-up), then the
        same chain captured into a graph for the key's later steps."""
        dev = self.device.torch_device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_members(skips)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = _bindings(self.units)
        before = launch_counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        for vec in self._vectors:
            vec._tracing = True
        try:
            with _tracing.TRACER.span(f"capture:{self.name}",
                                      cat="capture"):
                with torch.cuda.graph(graph):
                    self._run_members(skips, capture=True)
        finally:
            for vec in self._vectors:
                vec._tracing = False
        outputs, fixed = _split(warm, _bindings(self.units), dev)
        entry = _Graph(graph, launch_counts.delta(before), outputs, fixed)
        launch_counts.restore(before)  # the capture launched nothing
        # this step's values are the warm-up's
        _rebind((owner, name, warm[id(owner), name][2])
                for owner, name, _ in outputs if (id(owner), name) in warm)
        self._cache[key] = entry
        self._note_outputs((id(owner), name) for owner, name, _ in outputs)
        _metrics.graph_captures(self.name).inc()
        self.debug("region '%s': captured key %s (%d units)", self.name,
                   key, len(self.units))
        return entry

    def _note_outputs(self, keys) -> None:
        """An attribute that a step binds, of any key, is fixed in no
        graph."""
        self._outputs.update(keys)
        for entry in self._cache.values():
            entry.fixed = [f for f in entry.fixed if f[0] not in self._outputs]

    def _run_eager(self, skips) -> None:
        """One step's members in order; on the card, once graphs exist,
        what the step bound is noted as outputs (so that a ``mark``ed
        step of a key not captured yet does not read as a rebinding)."""
        if not self._cache:
            return self._run_members(skips)
        before = _bindings(self.units)
        self._run_members(skips)
        self._note_outputs(
            key for key, (_, _, value, _) in _bindings(self.units).items()
            if key not in before or before[key][2] is not value)

    def _replay(self, entry: _Graph, n: int) -> None:
        for _, label, owner, name, ptr in entry.fixed:
            value = _get(owner, name)
            if not isinstance(value, torch.Tensor) or value.data_ptr() != ptr:
                raise RuntimeError(
                    f"region '{self.name}': {label} was rebound after the "
                    f"capture, whose graph reads and writes the tensor it "
                    f"held then; write it in place (copy_) instead")
        _rebind(entry.outputs)
        for _ in range(n):
            entry.graph.replay()
        launch_counts.add(entry.launches, n)

    def run(self) -> None:
        """One step."""
        key, skips = self._prepare()
        if not self.graphed:
            self._run_eager(skips)
        else:
            entry = self._cache.get(key)
            if entry is None:
                self._capture(key, skips)
            else:
                self._replay(entry, 1)
        _metrics.region_steps(self.name).inc()

    def run_chunk(self, n_steps: int) -> None:
        """``n_steps`` steps with no host bookkeeping and no sync between
        them: the key's graph replayed ``n_steps`` times (the first step
        of a new key is its warm-up and capture).  The caller's
        contract is the reference's: every per-step input is device
        state the step advances itself (the loader's device schedule,
        the seed chains, the evaluator's sums), and the key does not
        change within the chunk; ``StandardWorkflow.run_chunked`` keeps
        both."""
        if n_steps == 1:
            return self.run()
        key, skips = self._prepare()
        with _tracing.TRACER.span(f"chunk:{self.name}", cat="region",
                                  steps=n_steps):
            if not self.graphed:
                for _ in range(n_steps):
                    self._run_eager(skips)
            else:
                entry = self._cache.get(key)
                left = n_steps
                if entry is None:
                    entry = self._capture(key, skips)
                    left -= 1
                self._replay(entry, left)
        _metrics.region_steps(self.name).inc(n_steps)


class RegionUnit(AcceleratedUnit):
    """The workflow node that runs a :class:`JitRegion` as one step.
    Its members keep their ``host_run`` in the control graph before it
    (the loader's pick); their device work runs here."""

    def __init__(self, workflow, units: Sequence[AcceleratedUnit],
                 name: str | None = None, **kwargs) -> None:
        super().__init__(workflow, name=name or "jit_region", **kwargs)
        self._member_units = list(units)
        self.region: JitRegion | None = None

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        for unit in self._member_units:
            if not unit.is_initialized:
                raise AttributeError(f"region member {unit} not initialized")
        self.region = JitRegion(self.name, self._member_units, self.device)

    def run(self) -> None:
        self.region.run()


class AcceleratedWorkflow(Workflow):
    """A workflow that owns a device (``Device.create``: the card unless
    the caller asks for the CPU)."""

    def __init__(self, workflow=None, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.device: Device | None = None

    def initialize(self, device=None, **kwargs) -> None:
        self.device = Device.create(device)
        super().initialize(device=self.device, **kwargs)

