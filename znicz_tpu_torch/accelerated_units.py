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
- :meth:`JitRegion.run_accum` runs one optimizer step over M
  microbatches: M − 1 replays of an accumulate-only graph, then one of
  an apply graph (:func:`current_accum_phase`).
- :class:`RegionUnit` puts a region into the workflow's graph and
  :class:`AcceleratedWorkflow` owns the device.  On the numpy oracle
  (:class:`~znicz_tpu_torch.backends.NumpyDevice`) there is no region:
  each unit's :meth:`~AcceleratedUnit.run` calls its ``numpy_run``.

``root.common.engine.debug_checks`` (default off) is the port's
counterpart of the reference's ``checkify`` region: a CUDA graph cannot
raise partway through a replay, so every member of a step writes, after
its device work, one device flag for each floating tensor it wrote
(:meth:`AcceleratedUnit.written_tensors`): whether it holds a NaN.  The
flags are one buffer that lives as long as the region; the host reads
it after the step (one sync) and raises a ``RuntimeError`` naming the
first unit in step order that produced a NaN, and the tensor.  The
checks are part of the region's key, so switching them on captures one
more graph and switching them off replays the old one; with them off
nothing of this is captured.  ``run_chunk`` with the checks on replays
one step at a time and reads the flags after each; ``run_accum``
refuses them, as the reference does.  On the numpy oracle the check is
a host check after each ``numpy_run``.  So is
``root.common.engine.fp8_matmul`` (:mod:`~znicz_tpu_torch.ops.fp8`):
:meth:`AcceleratedUnit.mxu_dot` then multiplies e4m3 operands, and
flipping the lever captures the step again.

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
fails raises, naming the unit.  The garbage collector does not run
during a capture (it could destroy a dropped region's graph there).
"""

from __future__ import annotations

import gc
from typing import Sequence

import numpy as np
import torch

from znicz_tpu_torch.backends import Device
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.ops.fp8 import fp8_dot, fp8_enabled
from znicz_tpu_torch.units import Unit
from znicz_tpu_torch.utils.config import register_defaults, root
from znicz_tpu_torch.utils.logger import Logger
from znicz_tpu_torch.workflow import Workflow

register_defaults("common", {"engine": {"debug_checks": False}})


def debug_checks_enabled() -> bool:
    """``root.common.engine.debug_checks`` (default off)."""
    return bool(root.common.engine.get("debug_checks", False))


def nan_error(where: str, unit, label: str) -> RuntimeError:
    """The located error of a NaN a unit wrote."""
    return RuntimeError(
        f"{where}: debug check failed: nan in '{label}' written by unit "
        f"'{unit.name}' ({type(unit).__name__}), the first unit of the "
        f"step to write one (root.common.engine.debug_checks)")


def nan_flag(flags: torch.Tensor, slot: int, tensor: torch.Tensor) -> None:
    """``flags[slot]`` ← whether ``tensor`` holds a NaN, on the device
    (no sync)."""
    nan_flag.launches += 1
    flags[slot] = torch.isnan(tensor).any()


nan_flag.launches = 0
launch_counts.register(nan_flag)


#: the accumulation phase of the region step being run or captured: None
#: (a fused step), ``("accum", M)`` (the microbatch's gradients summed
#: into the backward units' microbatch buffers, no parameter written) or
#: ``("apply", M)`` (the last microbatch: one optimizer step from the
#: sum).  A replay runs no Python, so the phase steers only what an
#: eager run or a capture records: each phase is its own graph.
_ACCUM_PHASE: tuple[str, int] | None = None


def current_accum_phase() -> tuple[str, int] | None:
    """The accumulation phase of the region step now running
    (``None``, ``("accum", M)`` or ``("apply", M)``)."""
    return _ACCUM_PHASE


class _Phase:
    """``with _Phase(phase):`` sets :data:`_ACCUM_PHASE` for a block."""

    def __init__(self, phase: tuple[str, int] | None) -> None:
        self.phase = phase

    def __enter__(self) -> None:
        global _ACCUM_PHASE
        self.prev, _ACCUM_PHASE = _ACCUM_PHASE, self.phase

    def __exit__(self, *exc) -> None:
        global _ACCUM_PHASE
        _ACCUM_PHASE = self.prev


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
    #: the attributes a step of the unit writes, whose floating tensors
    #: (or arrays, on the numpy oracle) ``engine.debug_checks`` checks
    WRITES: tuple = ()

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
        order).  The reference's ladder: with ``engine.fp8_matmul`` on,
        in either precision mode, the operands are e4m3
        (:class:`~znicz_tpu_torch.ops.fp8.Fp8Dot`)."""
        if fp8_enabled():
            return fp8_dot(a, b)
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

    def numpy_run(self) -> None:
        """The unit's step on the numpy oracle: the reference's numpy
        path, numpy only, reading and writing state through
        ``Tensor.numpy()`` views."""
        raise NotImplementedError(f"{type(self).__name__}.numpy_run")

    def run(self) -> None:
        self.host_run()
        if self._in_region:
            return  # the region runs the device work
        if self.device is not None and self.device.is_host_only:
            self.numpy_run()
            if debug_checks_enabled():
                self.check_host_nan()
            return
        self.device_run()

    def written_values(self) -> list[tuple[str, object]]:
        """``(label, value)`` of everything the unit's step may write:
        its :attr:`WRITES` (a backward unit adds the parameters and
        momentum it updates).  The labels do not change from step to
        step."""
        return [(name, getattr(self, name, None)) for name in self.WRITES]

    def written_tensors(self) -> list[tuple[str, object]]:
        """The :meth:`written_values` that hold a floating tensor (or a
        float array, on the numpy oracle)."""
        out = []
        for label, value in self.written_values():
            if isinstance(value, torch.Tensor):
                if value.is_floating_point():
                    out.append((label, value))
            elif isinstance(value, np.ndarray) \
                    and np.issubdtype(value.dtype, np.floating):
                out.append((label, value))
        return out

    def check_host_nan(self) -> None:
        """The numpy oracle's debug check: raise when a tensor this
        step wrote holds a NaN."""
        for label, value in self.written_tensors():
            arr = value.detach().numpy() \
                if isinstance(value, torch.Tensor) else value
            if np.isnan(arr).any():
                raise nan_error("numpy oracle", self, label)

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
        #: ``engine.debug_checks``: the NaN flags (bool, on the device)
        #: and, by member, the slot of each tensor it may write
        self._flags: torch.Tensor | None = None
        self._flag_slots: list[dict[str, int]] = []
        self._flag_owner: list[tuple] = []

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

    def _prepare(self) -> tuple[tuple, tuple, bool]:
        """Host writes to the device, then ``(key, skips, checks)``:
        the debug checks and the fp8 lever are part of the key."""
        if self._vectors is None:
            self._vectors = self._collect_vectors()
        for vec in self._vectors:
            vec.unmap()
        skips = tuple(bool(unit.gate_skip) for unit in self.units)
        for unit, skip in zip(self.units, skips):
            if not skip:
                unit.sync_host_state()
        key = tuple(unit.region_key() for unit in self.units) + (skips,)
        checks = debug_checks_enabled()
        if checks:
            self._alloc_flags()
            key += ("debug_checks",)
        if fp8_enabled():
            key += ("fp8_matmul",)
        return key, skips, checks

    def _alloc_flags(self) -> None:
        """The flag buffer, once a region: a slot for each tensor a
        member may write, in step order."""
        if self._flags is not None:
            return
        self._flag_slots, self._flag_owner = [], []
        for unit in self.units:
            slots = {}
            for label, _ in unit.written_values():
                slots[label] = len(self._flag_owner)
                self._flag_owner.append((unit, label))
            self._flag_slots.append(slots)
        self._flags = torch.zeros(max(len(self._flag_owner), 1),
                                  dtype=torch.bool,
                                  device=self.device.torch_device)

    def _write_flags(self, index: int, unit) -> None:
        slots = self._flag_slots[index]
        for label, tensor in unit.written_tensors():
            nan_flag(self._flags, slots[label], tensor)

    def _check_flags(self) -> None:
        """After a checked step: one read of the flags; raise naming the
        first unit in step order that wrote a NaN."""
        hit = torch.nonzero(self._flags.cpu())
        if len(hit):
            unit, label = self._flag_owner[int(hit[0, 0])]
            raise nan_error(f"region '{self.name}'", unit, label)

    def _run_members(self, skips, capture: bool = False,
                     checks: bool = False) -> None:
        grad = any(unit.NEEDS_AUTOGRAD and not skip
                   for unit, skip in zip(self.units, skips))
        mark = self.mark
        if checks:
            self._flags.zero_()
        with torch.set_grad_enabled(grad):
            for index, (unit, skip) in enumerate(zip(self.units, skips)):
                if skip:
                    continue
                if not capture:
                    with _tracing.TRACER.span(unit.name, cat="unit"):
                        unit.device_run()
                    if checks:
                        self._write_flags(index, unit)
                    if mark is not None:
                        mark(unit.name)
                    continue
                try:
                    unit.device_run()
                    if checks:
                        self._write_flags(index, unit)
                except Exception as exc:
                    raise RuntimeError(
                        f"region '{self.name}': the CUDA-graph capture "
                        f"failed in unit '{unit.name}' "
                        f"({type(unit).__name__}): {exc}") from exc

    def _capture(self, key, skips, checks: bool = False) -> _Graph:
        """This step eagerly on a side stream (the warm-up), then the
        same chain captured into a graph for the key's later steps."""
        dev = self.device.torch_device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_members(skips, checks=checks)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = _bindings(self.units)
        before = launch_counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        for vec in self._vectors:
            vec._tracing = True
        # a graph that nothing holds any more (a dropped workflow's) is
        # destroyed when the collector finds its cycle: destroyed during
        # a capture, it calls the driver, which invalidates the capture;
        # so collect now, and not again until the capture has ended
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _tracing.TRACER.span(f"capture:{self.name}",
                                      cat="capture"):
                with torch.cuda.graph(graph):
                    self._run_members(skips, capture=True, checks=checks)
        finally:
            if collecting:
                gc.enable()
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

    def _run_eager(self, skips, checks: bool = False) -> None:
        """One step's members in order; on the card, once graphs exist,
        what the step bound is noted as outputs (so that a ``mark``ed
        step of a key not captured yet does not read as a rebinding)."""
        if not self._cache:
            return self._run_members(skips, checks=checks)
        before = _bindings(self.units)
        self._run_members(skips, checks=checks)
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

    def _step(self, key, skips, checks: bool) -> None:
        """One step of a prepared key, its flags read when checked."""
        if not self.graphed:
            self._run_eager(skips, checks)
        else:
            entry = self._cache.get(key)
            if entry is None:
                self._capture(key, skips, checks)
            else:
                self._replay(entry, 1)
        if checks:
            self._check_flags()

    def run(self) -> None:
        """One step."""
        key, skips, checks = self._prepare()
        self._step(key, skips, checks)
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
        key, skips, checks = self._prepare()
        with _tracing.TRACER.span(f"chunk:{self.name}", cat="region",
                                  steps=n_steps):
            if checks:
                # one replay a step, its flags read after each (the
                # reference's per-step path under checkify)
                for _ in range(n_steps):
                    self._step(key, skips, checks)
            elif not self.graphed:
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

    def run_accum(self, n_micro: int) -> None:
        """One optimizer step over ``n_micro`` consecutive microbatches
        of the loader's device schedule, with no host work between them:
        the first ``n_micro − 1`` in the ``("accum", M)`` phase (forwards
        and gradients; each weighted backward unit adds its gradients to
        its f32 microbatch buffers and leaves its parameters and momentum
        alone), the last in the ``("apply", M)`` phase (the mean of the
        buffered sums through the unchanged update; the buffers zeroed).

        On the card these are two graphs, captured once per key
        ``(…, "accum", M)`` and ``(…, "apply", M)``: the accumulate graph
        replayed ``M − 1`` times, the apply graph once, the gather of
        each replay advancing the schedule's cursor as under
        :meth:`run_chunk`.  Elsewhere (the CPU, or a step with a
        ``mark``) the same phases run eagerly.  The caller's contract is
        :meth:`run_chunk`'s, and the microbatches are full train
        minibatches of one key; ``StandardWorkflow.run_accumulated``
        keeps it.  ``n_micro == 1`` is :meth:`run`."""
        if n_micro == 1:
            return self.run()
        if debug_checks_enabled():
            raise NotImplementedError(
                "engine.debug_checks does not compose with run_accum (the "
                "flags of the accumulated microbatches are not read "
                "between them); disable one of them")
        key, skips, _ = self._prepare()
        accum, apply = ("accum", n_micro), ("apply", n_micro)
        with _tracing.TRACER.span(f"accum:{self.name}", cat="region",
                                  micro=n_micro):
            if not self.graphed:
                for i in range(n_micro):
                    with _Phase(accum if i < n_micro - 1 else apply):
                        self._run_eager(skips)
            else:
                left = n_micro - 1
                with _Phase(accum):
                    entry = self._cache.get(key + accum)
                    if entry is None:
                        entry = self._capture(key + accum, skips)
                        left -= 1
                if left:
                    self._replay(entry, left)
                with _Phase(apply):
                    entry = self._cache.get(key + apply)
                    if entry is None:
                        self._capture(key + apply, skips)
                    else:
                        self._replay(entry, 1)
        _metrics.region_steps(self.name).inc(n_micro)


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
        if self.device.is_host_only:
            # the oracle: no region; the members run themselves
            for unit in self._member_units:
                unit._in_region = False
            self.gate_skip.value = True
            return
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

