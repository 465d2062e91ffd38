"""The population engine: K replicas of one workflow trained in one step
(port of ``znicz_tpu/population/engine.py``).

The reference ``jax.vmap``s the template's hot chain over a leading
member axis.  The port's kernels are C entry points and its units write
their state in place, neither of which ``vmap`` batches, so the port
runs the members **in turn inside one step**:

- :class:`PopulationRegion` owns member-stacked tensors of shape
  ``(K, …)``, each member's slice padded to 512 bytes (the caching
  allocator's granularity, so a member's view starts where a fresh
  allocation would and cuBLAS picks the kernel it picks for a lone
  run).  For member *i* it binds every member leaf of the template's
  units (parameters, buffers, Vectors, the seed chains) to its view
  ``stacked[i]`` and runs the template region's members
  (``JitRegion._run_members``); K times in a row.  On the card the K
  runs are captured into **one** CUDA graph per static key (through
  ``accelerated_units.capture_graph``, as every region's graph),
  so a replay trains all K members with no host work between them;
  elsewhere they run eagerly.  Member *i* is its sequential run bit for
  bit: its own weight init, seed chains (dropout) and epoch order.
- A leaf is **member** state when one eager train step of the template
  writes it in place (its ``_version`` moves); the loader's
  ``sched_perm``, every promoted ``lr_state`` and every seed chain are
  member state by rule.  A tensor the step binds anew is a step output:
  each member's is kept apart (:meth:`PopulationRegion.read_leaf` stacks
  them).  Everything else (the dataset, the schedule's tables) is
  **shared**, one copy, and a replay refuses it rebound after the
  capture, as it refuses a stacked tensor rebound.
- Between steps the template's units hold their own tensors again, so
  host code (the loader's schedule writes) never touches a member;
  :meth:`PopulationRegion.install_member` copies a member into them.
- Evolution (:mod:`znicz_tpu_torch.population.evolution`) runs at epoch
  boundaries as in-place gathers and blends over the stacked leaves.
- Over a mesh (:class:`~znicz_tpu_torch.parallel.mesh.Mesh`, one process
  a device) the member axis follows ``partition.Member``: when K divides
  the data axis, rank *r* holds members ``r·K/n … (r+1)·K/n − 1``; when
  not, every rank runs all K (with a warning).  Fitness and the
  evolvable rows are all-gathered exactly; every rank applies the same
  draws and keeps its own rows.

``engine.debug_checks`` is not supported inside the population step, as
in the reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import (capture_graph, check_bound,
                                               debug_checks_enabled,
                                               rebound_error)
from znicz_tpu_torch.loader.base import TRAIN, VALID, epoch_permutation
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.ops import launch_counts
from znicz_tpu_torch.population import evolution as _evo
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.logger import Logger

#: the bytes a member's slice of a stacked tensor is padded to
MEMBER_ALIGN = 512


def _unit_items(unit):
    """``(attr, table, value)`` of a unit's tensors and non-empty Vectors
    (its ``__dict__``, an ``nn.Module``'s parameters and buffers) and its
    seed chain, in sorted attribute order: the tables ``_bindings`` of
    :mod:`~znicz_tpu_torch.accelerated_units` walks."""
    items = []
    tables = [unit.__dict__, unit.__dict__.get("_parameters", {}),
              unit.__dict__.get("_buffers", {})]
    for table in tables:
        for attr, value in table.items():
            if isinstance(value, torch.Tensor) or (
                    isinstance(value, Vector) and value
                    and value._devmem is not None) or (
                    isinstance(value, prng.SeedChain)
                    and value.state is not None):
                items.append((attr, table, value))
    items.sort(key=lambda item: item[0])
    return items


def _unit_labels(units) -> list[str]:
    """Each unit's name, a repeated one suffixed ``#n`` by its
    occurrence (two layers of one type share a class name)."""
    seen: dict[str, int] = {}
    out = []
    for unit in units:
        n = seen.get(unit.name, 0)
        seen[unit.name] = n + 1
        out.append(unit.name if n == 0 else f"{unit.name}#{n}")
    return out


def _tensor_of(value) -> torch.Tensor:
    if isinstance(value, Vector):
        return value._devmem
    if isinstance(value, prng.SeedChain):
        return value.state
    return value


def _holder(table, attr, value) -> tuple:
    """Where a leaf's tensor is bound: ``(owner, name)``."""
    if isinstance(value, Vector):
        return value, "_devmem"
    if isinstance(value, prng.SeedChain):
        return value, "state"
    return table, attr


def _get(owner, name):
    return owner.get(name) if isinstance(owner, dict) \
        else getattr(owner, name, None)


def _set(owner, name, value) -> None:
    if isinstance(owner, dict):
        owner[name] = value
    else:
        setattr(owner, name, value)


def _root_chains(units) -> None:
    """Root every seed chain of ``units`` in step order, as a first train
    step's ``sync_host_state`` would (one draw each from its
    generator)."""
    for unit in units:
        chain = unit.__dict__.get("seed_chain")
        if isinstance(chain, prng.SeedChain):
            chain.sync(unit.torch_device)


def leaf_keys(units) -> dict[int, tuple[str, str]]:
    """A stable name for every tensor, Vector and seed chain a unit chain
    owns: ``id(object) -> (unit name, attribute)``, the first owner
    winning in (unit order, sorted attribute) order.  Two workflows
    built from one layers list have the same key set, so a member's
    harvested state lines up with the template's leaves."""
    out: dict[int, tuple[str, str]] = {}
    for label, unit in zip(_unit_labels(units), units):
        for attr, _, value in _unit_items(unit):
            out.setdefault(id(value), (label, attr))
    return out


def harvest_state(workflow) -> dict:
    """One freshly initialized member's state: a CPU copy of every
    tensor its hot chain owns by ``(unit, attribute)`` key, the roots of
    its seed chains (drawn here, in step order, as its first train step
    would draw them) and the loader's shuffle seed."""
    units = workflow.hot_chain_units()
    _root_chains(units)
    out: dict = {}
    for label, unit in zip(_unit_labels(units), units):
        for attr, _, value in _unit_items(unit):
            key = (label, attr)
            if key not in out:
                out[key] = _tensor_of(value).detach().to(
                    "cpu", copy=True)
    return {"tensors": out,
            "shuffle_seed": int(workflow.loader._shuffle_seed)}


class _Leaf:
    """One tensor of the template's step: where it is bound, its own
    tensor (``home``) and, for member state, its stacked buffer."""

    __slots__ = ("key", "home", "holders", "member", "evolvable",
                 "flat", "stride", "views", "binds", "objects")

    def __init__(self, key, home, holders, objects) -> None:
        self.key = key
        self.home = home
        self.holders = holders
        self.objects = objects
        self.member = False
        self.evolvable = False
        self.flat = None
        self.stride = 0
        self.views: list = []
        self.binds: list = []

    @property
    def label(self) -> str:
        return f"{self.key[0]}.{self.key[1]}"


class _PopGraph:
    """One captured population step: the graph, the launches its capture
    counted and each member's step outputs."""

    __slots__ = ("graph", "launches", "outputs")

    def __init__(self, graph, launches, outputs) -> None:
        self.graph = graph
        self.launches = launches
        self.outputs = outputs


class PopulationRegion(Logger):
    """The K-member step over a template workflow's hot chain.

    Owns the stacked leaves, the graphs (one per static key) and the
    per-member schedule.  Drive it like a region: :meth:`step` a
    minibatch (the host bookkeeping rides the template's loader); read
    and write leaves with :meth:`read_leaf` / :meth:`write_leaf`.
    """

    def __init__(self, template, member_states: Sequence[dict],
                 mesh=None, name: str = "population") -> None:
        super().__init__()
        self.name = name
        self.template = template
        self.n_members = len(member_states)
        if self.n_members < 1:
            raise ValueError("population needs at least 1 member")
        if template._region_unit is None:
            raise ValueError(
                "population needs a template initialized on the card or "
                "the CPU (the numpy oracle has no region to run)")
        self.device = template.device
        self.loader = template.loader
        self.region = template._region_unit.region
        self.units = self.region.units
        self.mesh = mesh
        self._shuffle_seeds = [int(s["shuffle_seed"]) for s in member_states]
        self._cache: dict[tuple, _PopGraph] = {}
        self._synced_epoch = 0
        self._outputs: list[dict] = []
        self._place_members()
        self._lr_tensors = [g.lr_state for g in template.gds
                            if g.lr_state is not None]
        if self.region._vectors is None:
            self.region._vectors = self.region._collect_vectors()
        self.vectors = self.region._vectors
        self._build(member_states)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _place_members(self) -> None:
        """This process's members: a block of ``K/n`` of them when K
        divides the mesh's data axis, else all K."""
        k = self.n_members
        mesh = self.mesh
        n_data = 1 if mesh is None else mesh.size("data")
        self.sharded = mesh is not None and n_data > 1 and k % n_data == 0
        if mesh is not None and n_data > 1 and not self.sharded:
            self.warning(
                "population of %d does not divide the %d-way data axis — "
                "every process runs all members", k, n_data)
        if self.sharded:
            per = k // n_data
            first = mesh.index("data") * per
            self.members = list(range(first, first + per))
        else:
            self.members = list(range(k))
        self.n_local = len(self.members)

    def _walk(self) -> dict:
        """``{id(tensor): _Leaf}`` of every tensor the units hold now."""
        leaves: dict[int, _Leaf] = {}
        for label, unit in zip(_unit_labels(self.units), self.units):
            for attr, table, value in _unit_items(unit):
                tensor = _tensor_of(value)
                leaf = leaves.get(id(tensor))
                holder = _holder(table, attr, value)
                if leaf is None:
                    leaves[id(tensor)] = _Leaf((label, attr), tensor,
                                               [holder], [value])
                elif not any(o is holder[0] and n == holder[1]
                             for o, n in leaf.holders):
                    leaf.holders.append(holder)
                    leaf.objects.append(value)
        return leaves

    @torch.no_grad()
    def _restore(self, leaves: dict, saved: dict) -> None:
        for leaf in leaves.values():
            for owner, name in leaf.holders:
                _set(owner, name, leaf.home)
            leaf.home.copy_(saved[id(leaf.home)])

    def _detect(self, leaves: dict) -> tuple[set, set]:
        """One eager train step of the template (then undone): the ids of
        the tensors it wrote in place, and of those it bound anew (step
        outputs that existed before it)."""
        loader = self.loader
        saved_class = loader.minibatch_class
        loader.minibatch_class = TRAIN
        saved = {tid: leaf.home.detach().clone()
                 for tid, leaf in leaves.items()}
        versions = {tid: leaf.home._version for tid, leaf in leaves.items()}
        try:
            _, skips, _ = self.region._prepare()
            self.region._run_members(skips)
            written = {tid for tid, leaf in leaves.items()
                       if leaf.home._version != versions[tid]}
            rebound = {tid for tid, leaf in leaves.items()
                       if any(_get(owner, name) is not leaf.home
                              for owner, name in leaf.holders)}
        finally:
            self._restore(leaves, saved)
            loader.minibatch_class = saved_class
        return written, rebound

    def _build(self, member_states: Sequence[dict]) -> None:
        # current under the latest seed_all, so that no step re-roots a
        # chain (the template's own chains are not a member's: the
        # members' roots come from their harvests)
        _root_chains(self.units)
        leaves = self._walk()
        written, rebound = self._detect(leaves)
        sched_perm = getattr(self.loader, "sched_perm", None)
        forced = {id(t) for t in self._lr_tensors}
        if isinstance(sched_perm, Vector) and sched_perm:
            forced.add(id(sched_perm._devmem))
        self.leaves: list[_Leaf] = [
            leaf for tid, leaf in leaves.items()
            if tid not in rebound or tid in forced]
        self._by_id: dict[int, int] = {}
        for j, leaf in enumerate(self.leaves):
            chain = any(isinstance(o, prng.SeedChain) for o in leaf.objects)
            leaf.member = (id(leaf.home) in written or id(leaf.home) in forced
                           or chain)
            leaf.evolvable = leaf.member and not chain and not any(
                o is sched_perm for o in leaf.objects)
            self._by_id[id(leaf.home)] = j
            for obj in leaf.objects:
                self._by_id[id(obj)] = j
            if leaf.member:
                self._stack(leaf, member_states, sched_perm)
        self._fixed = [(leaf.label, owner, name, leaf.home.data_ptr())
                       for leaf in self.leaves if not leaf.member
                       for owner, name in leaf.holders]
        self._stacked_ptrs = [(leaf.label, leaf.flat.data_ptr())
                              for leaf in self.leaves if leaf.member]
        _metrics.population_members(self.name).set(self.n_members)

    @torch.no_grad()
    def _stack(self, leaf: _Leaf, member_states, sched_perm) -> None:
        home = leaf.home
        numel = max(home.numel(), 1)
        per = max(1, MEMBER_ALIGN // home.element_size())
        leaf.stride = -(-numel // per) * per
        raw = torch.zeros(self.n_local * leaf.stride + per, dtype=home.dtype,
                          device=home.device)
        # the first member starts on the boundary too, whatever the
        # allocator's own alignment
        first = (-raw.data_ptr() % MEMBER_ALIGN) // home.element_size()
        leaf.flat = raw[first:first + self.n_local * leaf.stride]
        leaf.views = [leaf.flat[i * leaf.stride:i * leaf.stride
                                + home.numel()].view(home.shape)
                      for i in range(self.n_local)]
        is_param = any(isinstance(o, torch.nn.Parameter)
                       for o in leaf.objects)
        # a parameter autograd differentiates (attention's) stays one
        leaf.binds = [torch.nn.Parameter(v, requires_grad=home.requires_grad)
                      if is_param else v for v in leaf.views]
        if any(o is sched_perm for o in leaf.objects):
            init = torch.from_numpy(self.stacked_epoch_orders(0))
            for i, view in enumerate(leaf.views):
                view.copy_(init[i].to(home.dtype))
            return
        for i, member in enumerate(self.members):
            value = member_states[member]["tensors"].get(leaf.key)
            src = home if value is None or tuple(value.shape) != \
                tuple(home.shape) else value
            leaf.views[i].copy_(src.to(home.dtype))

    # ------------------------------------------------------------------
    # per-member schedule
    # ------------------------------------------------------------------
    def stacked_epoch_orders(self, epoch: int) -> np.ndarray:
        """``(members here, total samples)`` int64: each member's sample
        order for ``epoch``: test and validation in natural order, the
        TRAIN segment the member's own counter-based permutation."""
        loader = self.loader
        total = loader.total_samples
        lo, hi = loader.class_index_range(TRAIN)
        out = np.tile(np.arange(total, dtype=np.int64), (self.n_local, 1))
        n = hi - lo
        if n > 0 and loader.shuffle_limit > 0:
            eff = min(int(epoch), int(loader.shuffle_limit) - 1)
            for i, member in enumerate(self.members):
                out[i, lo:hi] = lo + epoch_permutation(
                    self._shuffle_seeds[member], eff, n)
        return out

    def _sync_schedule(self) -> None:
        epoch = int(self.loader.epoch_number)
        if epoch == self._synced_epoch:
            return
        self._synced_epoch = epoch
        sched_perm = getattr(self.loader, "sched_perm", None)
        if not isinstance(sched_perm, Vector) or not sched_perm:
            return
        self.svec(sched_perm).copy_(torch.from_numpy(
            self.stacked_epoch_orders(epoch)))

    # ------------------------------------------------------------------
    # leaf access
    # ------------------------------------------------------------------
    def _leaf(self, obj) -> _Leaf | None:
        j = self._by_id.get(id(obj))
        return None if j is None else self.leaves[j]

    def svec(self, obj) -> torch.Tensor:
        """The stacked ``(members here, …)`` tensor of a member leaf (a
        strided view of its padded buffer)."""
        leaf = self._leaf(obj)
        if leaf is None or not leaf.member:
            raise KeyError(f"{obj!r} is not a member leaf of the "
                           f"population")
        shape = tuple(leaf.home.shape)
        strides = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            strides[d] = strides[d + 1] * shape[d + 1]
        return leaf.flat.as_strided((self.n_local,) + shape,
                                    (leaf.stride,) + tuple(strides))

    def is_member(self, obj) -> bool:
        leaf = self._leaf(obj)
        return leaf is not None and leaf.member

    def _output_stack(self, obj) -> torch.Tensor | None:
        if not self._outputs:
            return None
        for key, (owner, name, value) in self._outputs[-1].items():
            if value is obj:
                return torch.stack([out[key][2] for out in self._outputs])
        return None

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def read_leaf(self, obj) -> np.ndarray:
        """Host copy of a leaf's current value: ``(members here, …)`` for
        member state and step outputs (the last step's, member by
        member), the tensor itself for shared state.  ``obj`` is what a
        template unit holds: a tensor, a Vector or a seed chain."""
        leaf = self._leaf(obj)
        if leaf is not None:
            return self._host(self.svec(obj) if leaf.member else leaf.home)
        stacked = self._output_stack(obj)
        if stacked is None:
            raise KeyError(f"{obj!r} is neither a leaf nor a step output "
                           f"of the population")
        return self._host(stacked)

    @torch.no_grad()
    def write_leaf(self, obj, arr) -> None:
        """Write a member leaf in place (``arr`` broadcasts over the
        members here)."""
        dst = self.svec(obj)
        src = torch.as_tensor(np.asarray(arr))
        dst.copy_(src.to(dst.dtype).expand(dst.shape))

    def gather_leaf(self, obj) -> np.ndarray:
        """``(K, …)``: every member's value of a member leaf; a
        collective over the data axis when the members are spread."""
        local = self.read_leaf(obj)
        if not self.sharded:
            return local
        return self._gather_rows(torch.from_numpy(local)).numpy()

    def set_member_lrs(self, lrs: Sequence[float]) -> None:
        """Each member's learning rate, into both rate slots of every
        promoted ``lr_state`` (``build(learning_rate=…)``'s semantic);
        ``lrs`` has all K rates."""
        if len(lrs) != self.n_members:
            raise ValueError(f"{len(lrs)} rates for {self.n_members} "
                             f"members")
        if not self._lr_tensors:
            raise ValueError(
                "template has no promoted lr leaves — call "
                "StandardWorkflow.promote_lr_leaves() before building the "
                "population")
        stacked = np.asarray([[lrs[m], lrs[m]] for m in self.members],
                             dtype=np.float32)
        for t in self._lr_tensors:
            self.write_leaf(t, stacked)

    def member_lrs(self) -> np.ndarray:
        """``(K,)`` each member's learning rate (the first promoted unit's
        weight-rate slot)."""
        if not self._lr_tensors:
            raise ValueError("no promoted lr leaves")
        return np.array(self.gather_leaf(self._lr_tensors[0])[:, 0],
                        dtype=np.float64)

    # ------------------------------------------------------------------
    # binding
    # ------------------------------------------------------------------
    def _bind(self, i: int | None) -> None:
        """Member ``i``'s views into the units (None: their own
        tensors)."""
        for leaf in self.leaves:
            if not leaf.member:
                continue
            value = leaf.home if i is None else leaf.binds[i]
            for owner, name in leaf.holders:
                _set(owner, name, value)

    def _step_outputs(self, before: dict) -> dict:
        """The tensors a member's run bound that are no leaf."""
        out = {}
        for unit in self.units:
            for attr, table, value in _unit_items(unit):
                if isinstance(value, (Vector, prng.SeedChain)):
                    continue
                if id(value) in before:
                    continue
                out[(id(table), attr)] = (table, attr, value)
        return out

    def _leaf_ids(self, i: int | None) -> set:
        ids = set()
        for leaf in self.leaves:
            ids.add(id(leaf.home))
            if leaf.member and i is not None:
                ids.add(id(leaf.binds[i]))
        return ids

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    @property
    def graphed(self) -> bool:
        """True on the card: the K members' step is one CUDA graph."""
        return self.device.type == "cuda"

    @property
    def captures(self) -> int:
        """Graphs captured so far (one per key seen)."""
        return len(self._cache)

    def _prepare(self) -> tuple[tuple, tuple]:
        if debug_checks_enabled():
            raise NotImplementedError(
                "engine.debug_checks is not supported inside the "
                "population step (as in the reference)")
        key, skips, _ = self.region._prepare()
        return key, skips

    def _run_all(self, skips, capture: bool = False) -> list[dict]:
        outputs = []
        try:
            for i in range(self.n_local):
                self._bind(i)
                ids = self._leaf_ids(i)
                self.region._run_members(skips, capture=capture)
                outputs.append(self._step_outputs(ids))
        finally:
            self._bind(None)
        return outputs

    def _capture(self, key, skips) -> None:
        graph, launches, warm, outputs = capture_graph(
            self.device.torch_device, f"capture:population:{self.name}",
            self.vectors, lambda: self._run_all(skips),
            lambda: self._run_all(skips, capture=True))
        entry = _PopGraph(graph, launches, outputs)
        self._cache[key] = entry
        # this step's values are the warm-up's
        self._outputs = warm
        self._bind_outputs(warm[-1])
        _metrics.graph_captures(f"population:{self.name}").inc()
        self.debug("population '%s': captured key %s (%d members)",
                   self.name, key, self.n_local)

    @staticmethod
    def _bind_outputs(outputs: dict) -> None:
        for owner, name, value in outputs.values():
            _set(owner, name, value)

    def _check_bindings(self) -> None:
        where = f"population '{self.name}'"
        check_bound(where, self._fixed)
        for (label, ptr), leaf in zip(
                self._stacked_ptrs,
                [lf for lf in self.leaves if lf.member]):
            if leaf.flat.data_ptr() != ptr:
                raise rebound_error(where, f"the stacked {label}")

    def _replay(self, entry: _PopGraph) -> None:
        self._check_bindings()
        entry.graph.replay()
        launch_counts.add(entry.launches, 1)
        self._outputs = entry.outputs
        self._bind_outputs(entry.outputs[-1])

    def _dispatch(self) -> None:
        key, skips = self._prepare()
        with _tracing.TRACER.span(f"population:{self.name}", cat="region"):
            if not self.graphed:
                self._outputs = self._run_all(skips)
                self._bind_outputs(self._outputs[-1])
            else:
                entry = self._cache.get(key)
                if entry is None:
                    self._capture(key, skips)
                else:
                    self._replay(entry)
        _metrics.region_steps(f"population:{self.name}").inc()

    def step(self) -> None:
        """One minibatch for every member: the template loader's host
        bookkeeping (the schedule's geometry is every member's), each
        member's order at an epoch's start, then one dispatch (one
        replay on the card)."""
        self.loader.run()
        self._sync_schedule()
        self._dispatch()

    def run_schedule_entry(self, position: int) -> None:
        """The step of one explicit schedule entry (the stacked
        ensemble's aggregate pass): the device cursor and the template
        loader's host state at ``position``, then the matching variant.
        Leaves the training cursor moved: use after training only."""
        loader = self.loader
        cls, lo, hi = loader._schedule[position]
        loader.minibatch_class = cls
        loader.minibatch_size = hi - lo
        loader.minibatch_offset = lo
        cursor = getattr(loader, "sched_cursor", None)
        if not isinstance(cursor, Vector) or not cursor:
            raise ValueError("population eval pass needs the "
                             "device-resident schedule")
        self.write_leaf(cursor, np.full((self.n_local,), position,
                                        dtype=np.int64))
        self._dispatch()

    # ------------------------------------------------------------------
    # member readout / install
    # ------------------------------------------------------------------
    @torch.no_grad()
    def install_member(self, member: int) -> None:
        """Copy member ``member``'s value of every member leaf into the
        template's own tensors, in place: the template becomes the member
        (the bridge to export, ``publish_bundle`` and serving).  A
        collective when the members are spread over a mesh."""
        if not 0 <= member < self.n_members:
            raise ValueError(f"member {member} out of range")
        for leaf in self.leaves:
            if not leaf.member:
                continue
            rows = self.svec(leaf.home)
            if self.sharded:
                rows = self._gather_rows(rows)
                row = rows[member]
            else:
                row = rows[self.members.index(member)]
            leaf.home.copy_(row.to(leaf.home.device))

    # ------------------------------------------------------------------
    # evolution
    # ------------------------------------------------------------------
    def evolvable_slots(self) -> list[int]:
        """The leaves evolution may touch: member state but the seed
        chains and the epoch order (each member's identity)."""
        return [j for j, leaf in enumerate(self.leaves) if leaf.evolvable]

    def lr_slots_within(self, slots: Sequence[int]) -> list[int]:
        lr_ids = {id(t) for t in self._lr_tensors}
        return [n for n, j in enumerate(slots)
                if id(self.leaves[j].home) in lr_ids]

    def slot_dtypes(self, slots: Sequence[int]) -> list[torch.dtype]:
        return [self.leaves[j].home.dtype for j in slots]

    def _gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """``(K, …)`` from each process's ``(K/n, …)`` rows over the data
        axis, exactly (bf16 and bool travel as their bits)."""
        import torch.distributed as dist
        group = self.mesh.group("data")
        n = self.mesh.size("data")
        wire = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        t = rows.detach().contiguous()
        dtype = t.dtype
        if dtype == torch.bfloat16:
            t = t.view(torch.int16)
        elif dtype == torch.bool:
            t = t.to(torch.uint8)
        t = t.to(wire)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts).to(rows.device)
        if dtype == torch.bfloat16:
            out = out.view(torch.bfloat16)
        elif dtype == torch.bool:
            out = out.bool()
        return out

    @torch.no_grad()
    def apply_evolution(self, fn, fitness: np.ndarray,
                        generator: torch.Generator):
        """Run an evolution step (``fn(fitness, generator, *leaves)``,
        :mod:`~znicz_tpu_torch.population.evolution`) over the evolvable
        leaves in place; returns its draws.  Over a spread member axis
        every process gathers all rows, applies the same draws and keeps
        its own."""
        slots = self.evolvable_slots()
        local = [self.svec(self.leaves[j].home) for j in slots]
        if not self.sharded:
            return fn(fitness, generator, *local)
        full = [self._gather_rows(rows) for rows in local]
        draws = fn(fitness, generator, *full)
        first = self.members[0]
        for rows, whole in zip(local, full):
            rows.copy_(whole[first:first + self.n_local])
        return draws


class PopulationTrainer(Logger):
    """Build K members of one sample architecture, train them together
    through a :class:`PopulationRegion`, evolve at epoch boundaries and
    keep each member's fitness.

    Parameters
    ----------
    build_fn:
        ``callable(**build_kwargs) -> StandardWorkflow`` (a sample's
        ``build``).
    n_members / base_seed / member_seeds:
        member *i* is the workflow ``build_fn`` gives after
        ``prng.seed_all(member_seeds[i])`` (default ``base_seed + i``):
        its weight init, seed chains and epoch order follow that seed, as
        an independent run's would.  A repeated seed shares one harvest.
    mesh:
        a :class:`~znicz_tpu_torch.parallel.mesh.Mesh` over the
        processes, or None (one device).
    member_lrs / lr_bounds:
        each member's learning rate (through the promoted ``lr_state``)
        and the range evolution keeps them in.
    evolve:
        ``"pbt"``, ``"ga"`` or None (stacked training only: the ensemble
        and genetics mode).
    device:
        where the template trains: None (the card; an error without
        one) or ``"cpu"``.  With a mesh, this process's device.
    """

    def __init__(self, build_fn: Callable, n_members: int,
                 base_seed: int | None = None,
                 member_seeds: Sequence[int] | None = None,
                 build_kwargs: dict | None = None,
                 mesh=None,
                 member_lrs: Sequence[float] | None = None,
                 lr_bounds: tuple[float, float] | None = None,
                 evolve: str | None = "pbt",
                 evolve_every: int = 1,
                 truncation: float = 0.25,
                 elite: int = 1,
                 mutation_sigma: float = 0.2,
                 explore_factors: tuple[float, float] = (0.8, 1.25),
                 seed: int = 777,
                 name: str = "population",
                 device=None) -> None:
        super().__init__()
        from znicz_tpu_torch.utils.config import root
        if n_members < 1:
            raise ValueError("n_members must be >= 1")
        if evolve not in (None, "pbt", "ga"):
            raise ValueError(f"unknown evolve strategy '{evolve}'")
        self.build_fn = build_fn
        self.n_members = int(n_members)
        if member_seeds is not None:
            if len(member_seeds) != n_members:
                raise ValueError("member_seeds length mismatch")
            self.member_seeds = [int(s) for s in member_seeds]
        else:
            base = int(root.common.seed if base_seed is None else base_seed)
            self.member_seeds = [base + i for i in range(n_members)]
        self.build_kwargs = dict(build_kwargs or {})
        self.mesh = mesh
        self.member_lrs = (None if member_lrs is None
                           else [float(x) for x in member_lrs])
        self.lr_bounds = lr_bounds
        self.evolve = evolve
        self.evolve_every = max(1, int(evolve_every))
        self.truncation = float(truncation)
        self.elite = int(elite)
        self.mutation_sigma = float(mutation_sigma)
        self.explore_factors = explore_factors
        self.seed = int(seed)
        self.name = name
        self.device = device
        self.template = None
        self.region: PopulationRegion | None = None
        self.history: list[dict] = []
        self.generations = 0
        #: the best fitness each member has reached so far
        self.member_best_fitness = np.full(n_members, -np.inf)
        self.best_fitness = -np.inf
        self.best_member: int | None = None
        self._evolve_fn = None
        self._evolve_meta = (None, 0)

    # ------------------------------------------------------------------
    def _template_device(self):
        mesh = self.mesh
        if mesh is None:
            return self.device
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return "cpu"

    def initialize(self) -> "PopulationTrainer":
        if self.region is not None:
            return self
        template_device = self._template_device()
        states: list[dict] = []
        by_seed: dict[int, dict] = {}
        for i, s in enumerate(self.member_seeds):
            if i > 0 and s in by_seed:
                states.append(by_seed[s])
                continue
            prng.seed_all(s)
            wf = self.build_fn(**self.build_kwargs)
            wf._max_fires = None
            if i == 0:
                wf.initialize(device=template_device)
                wf.promote_lr_leaves()
                self.template = wf
            else:
                wf.initialize(device="cpu")
            state = harvest_state(wf)
            by_seed[s] = state
            states.append(state)
        self.region = PopulationRegion(self.template, states, mesh=self.mesh,
                                       name=self.name)
        if self.member_lrs is not None:
            self.region.set_member_lrs(self.member_lrs)
        return self

    # ------------------------------------------------------------------
    # fitness
    # ------------------------------------------------------------------
    @property
    def _metric_class(self) -> int:
        loader = self.template.loader
        return VALID if loader.class_lengths[VALID] > 0 else TRAIN

    def _gather_fitness(self, local: np.ndarray) -> np.ndarray:
        region = self.region
        if not region.sharded:
            return local
        return region._gather_rows(torch.from_numpy(
            np.asarray(local, dtype=np.float64))).numpy()

    def _read_epoch_fitness(self) -> np.ndarray:
        """``(K,)`` fitness of the epoch that just ended (higher is
        better): ``-validation_err_pt`` for a classifier,
        ``-validation_mse`` for a regression; the stacked evaluator sums
        are zeroed in place afterwards, as a decision zeroes its
        per-epoch sums."""
        region = self.region
        wf = self.template
        ev = wf.evaluator
        cls = self._metric_class
        length = max(1, wf.loader.class_lengths[cls])
        if wf.loss == "softmax":
            errs = np.array(region.read_leaf(ev.epoch_n_err), dtype=np.int64)
            fitness = -100.0 * errs[:, cls] / length
            region.write_leaf(ev.epoch_n_err, 0)
            if ev.epoch_loss is not None:
                region.write_leaf(ev.epoch_loss, 0.0)
            if ev.confusion_matrix is not None:
                region.write_leaf(ev.confusion_matrix, 0)
        else:
            sse = np.array(region.read_leaf(ev.epoch_sse), dtype=np.float64)
            fitness = -sse[:, cls] / length
            region.write_leaf(ev.epoch_sse, 0.0)
        return self._gather_fitness(fitness)

    def _record_fitness(self, fitness: np.ndarray) -> None:
        self.member_best_fitness = np.maximum(self.member_best_fitness,
                                              fitness)
        best = int(np.argmax(fitness))
        if fitness[best] > self.best_fitness:
            self.best_fitness = float(fitness[best])
        self.best_member = best
        if _metrics.enabled():
            for i, f in enumerate(fitness):
                _metrics.population_fitness(self.name, i).set(float(f))
            _metrics.population_best_fitness(self.name).set(
                self.best_fitness)

    # ------------------------------------------------------------------
    # evolution
    # ------------------------------------------------------------------
    def _evolution_program(self):
        if self._evolve_fn is not None:
            return self._evolve_fn
        region = self.region
        slots = region.evolvable_slots()
        lr_slots = region.lr_slots_within(slots)
        if self.evolve == "pbt":
            fn, n_cut = _evo.build_pbt_step(
                self.n_members, lr_slots, truncation=self.truncation,
                factors=self.explore_factors, lr_bounds=self.lr_bounds)
            self._evolve_meta = ("pbt", n_cut)
        else:
            blendable = [dt.is_floating_point
                         for dt in region.slot_dtypes(slots)]
            fn, n_elite = _evo.build_ga_step(
                self.n_members, blendable, lr_slots, elite=self.elite,
                mutation_sigma=self.mutation_sigma, lr_bounds=self.lr_bounds)
            self._evolve_meta = ("ga", n_elite)
        self._evolve_fn = fn
        return fn

    def evolve_generation(self, fitness: np.ndarray) -> None:
        """One evolution generation over the stacked leaves (at epoch
        boundaries from :meth:`run`; callable directly)."""
        if self.evolve is None or self.n_members < 2:
            return
        fn = self._evolution_program()
        generator = _evo.generation_generator(
            self.seed, self.generations, self.template.device.torch_device)
        self.region.apply_evolution(
            fn, np.asarray(fitness, dtype=np.float64), generator)
        self.generations += 1
        strategy, n = self._evolve_meta
        if _metrics.enabled():
            _metrics.population_generations(self.name).inc()
            if strategy == "pbt":
                _metrics.population_evolution(self.name, "exploit").inc(n)
                _metrics.population_evolution(self.name, "explore").inc(n)
            else:
                refilled = self.n_members - n
                _metrics.population_evolution(self.name,
                                              "crossover").inc(refilled)
                _metrics.population_evolution(self.name,
                                              "mutate").inc(refilled)

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def run_epoch(self) -> np.ndarray:
        """One epoch of the schedule for all K members; returns the
        ``(K,)`` epoch fitness."""
        region = self.region
        loader = self.template.loader
        while True:
            region.step()
            if loader.epoch_ended:
                break
        fitness = self._read_epoch_fitness()
        self._record_fitness(fitness)
        return fitness

    def run(self, max_epochs: int | None = None) -> list[dict]:
        """Train for ``max_epochs`` (default: the template decision's
        budget), evolving every ``evolve_every`` epochs (never after the
        last)."""
        if self.region is None:
            self.initialize()
        if max_epochs is None:
            max_epochs = self.template.decision.max_epochs
        if not max_epochs:
            raise ValueError("max_epochs undecided: pass it here or in the "
                             "template's decision_config")
        for epoch in range(int(max_epochs)):
            fitness = self.run_epoch()
            entry = {
                "epoch": epoch,
                "fitness": [float(f) for f in fitness],
                "best": float(np.max(fitness)),
                "mean": float(np.mean(fitness)),
                "best_member": int(np.argmax(fitness)),
            }
            if self.region._lr_tensors:
                entry["lrs"] = [float(x) for x in self.region.member_lrs()]
            self.history.append(entry)
            self.info("epoch %d: best %.4f mean %.4f (member %d)", epoch,
                      entry["best"], entry["mean"], entry["best_member"])
            if epoch + 1 < max_epochs \
                    and (epoch + 1) % self.evolve_every == 0:
                self.evolve_generation(fitness)
        return self.history

    # ------------------------------------------------------------------
    # the best member out (PBT → serving)
    # ------------------------------------------------------------------
    def install_best(self) -> int:
        """The best member's state into the template; returns its
        index."""
        if self.best_member is None:
            raise RuntimeError("run() first")
        self.region.install_member(self.best_member)
        return self.best_member

    def export_best(self, path: str) -> str:
        self.install_best()
        return self.template.export_forward(path)

    def publish_best(self, directory: str,
                     prefix: str = "model") -> tuple[int, str]:
        """Publish the best member as the next version in ``directory``
        (a bundle with its sha256 sidecar), which a
        ``PublicationWatcher`` and a ``SwapController`` pick up."""
        from znicz_tpu_torch.resilience.publisher import publish_bundle
        self.install_best()
        return publish_bundle(self.template, directory, prefix=prefix)


def train_drafter(build_fn: Callable, n_members: int = 4, *,
                  publish_dir: str, prefix: str = "drafter",
                  mesh=None, base_seed: int = 211,
                  lr_bounds: tuple[float, float] = (0.01, 0.4),
                  evolve: str = "pbt", evolve_every: int = 2,
                  seed: int = 97, name: str = "drafter",
                  **trainer_kwargs) -> tuple[int, str, "PopulationTrainer"]:
    """Train a population of small causal LMs (``build_fn`` gives the
    drafter: embedding → causal attention → last_token → softmax), each
    member its own seed and rate, and publish the fittest as the
    speculative decoder's drafter.  A drafter only costs acceptance
    rate, never correctness: the big model's verify pass decides every
    token.  Returns ``(version, bundle_path, trainer)``."""
    trainer = PopulationTrainer(
        build_fn, n_members, base_seed=base_seed, mesh=mesh,
        lr_bounds=lr_bounds, evolve=evolve, evolve_every=evolve_every,
        seed=seed, name=name, **trainer_kwargs)
    trainer.initialize()
    trainer.run()
    version, path = trainer.publish_best(publish_dir, prefix=prefix)
    return version, path, trainer
