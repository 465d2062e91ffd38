"""The declarative partition-rule engine: one table per workflow (port
of ``znicz_tpu/parallel/partition.py``).

Each workflow owns ONE ordered table of ``(name-regex, placement)``
rules over canonical ``unit.name/slot`` leaf paths, and resolution is
the reference's:

- **scalars replicated** — 0-d / single-element leaves short-circuit to
  the empty spec before any rule is consulted;
- **first match wins** — unit-declared overrides (exact, anchored
  paths) precede the framework's default tail;
- **unmatched leaves are a hard error** — there is no silent
  replicated fallback.

The placements are plain data: which dim rides which axis, and what
zero padding ZeRO-1 adds (:class:`Zero1` and :class:`Member` derive
``(data_shard_dim, pad)`` and member-axis divisibility from the leaf's
logical shape at resolution time).  A spec is a tuple with one entry a
dim, an axis name or None.  Nothing here moves a tensor: the units read
a leaf's :class:`ResolvedPartition` to decide what this process holds
and which collective it runs (``GradientDescentBase`` for ZeRO-1,
``All2All`` for the model axis), and :func:`local_slice` /
:func:`gather_full` cut a logical array to this process's shard and
assemble it back, which is how snapshots and exported bundles stay in
logical shapes and resume on any layout.

``root.common.engine.partition_rules = False`` is the reference's
legacy arm: the same declarative call sites apply the equivalent
decision directly, without a table; the golden-table test pins the two
arms equal.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from znicz_tpu_torch.parallel.axis import (DATA_AXIS, MODEL_AXIS,
                                           SEQ_AXIS)


def _pspec(*entries) -> tuple:
    """A spec: one entry a dim, an axis name or None."""
    return tuple(entries)


class UnmatchedLeafError(LookupError):
    """A leaf path matched no rule — the hard-error contract (no
    silent replicated fallback)."""


class PartitionMismatchError(ValueError):
    """A resolved placement contradicts the Vector's structural kind
    (e.g. a batch-major buffer resolved to a non-batch spec) — almost
    always a missing or mis-ordered rule."""


# ----------------------------------------------------------------------
# placements — the right-hand side of a rule
# ----------------------------------------------------------------------
class _Singleton:
    _NAME = "?"

    def __repr__(self) -> str:  # table dumps stay readable
        return self._NAME


class _Batch(_Singleton):
    """Dim 0 is the minibatch: rides the mesh's data axis."""
    _NAME = "BATCH"


class _Replicated(_Singleton):
    """Fully replicated (parameters, scalars, schedule tables)."""
    _NAME = "REPLICATED"


BATCH = _Batch()
REPLICATED = _Replicated()


@dataclass(frozen=True)
class Zero1:
    """ZeRO-1 optimizer-state placement: the data-sharded dim and its
    zero padding are DERIVED from the leaf's logical shape via
    ``mesh.zero1_partition`` (largest evenly-dividing dim, else the
    largest dim padded up); ``model_dim`` composes as a 2-D sharding
    exactly like the attribute path did."""
    model_dim: int | None = None

    def __repr__(self) -> str:
        return f"ZERO1(model_dim={self.model_dim})"


@dataclass(frozen=True)
class Member:
    """Population-stacked placement: dim 0 is the member axis and
    rides the mesh's data axis when the member count divides it (an
    indivisible K stays replicated — XLA time-slices the members);
    ``model_dim`` is a member's TP dim, already shifted by the leading
    member axis."""
    model_dim: int | None = None

    def __repr__(self) -> str:
        return f"MEMBER(model_dim={self.model_dim})"


@dataclass(frozen=True)
class Stage:
    """Pipeline-stage placement tag: every leaf the rule
    matches belongs to pipeline stage ``index`` on the mesh's ``pipe``
    axis.  A Stage rule decides WHICH stage owns a leaf, not how the
    leaf shards inside the stage: ``inner`` (when given) is the
    within-stage placement; ``inner=None`` falls through to the next
    matching rule — typically the defaults tail — so a unit's existing
    BATCH/ZERO1/TP declarations keep working verbatim under staging."""
    index: int
    inner: object = None

    def __repr__(self) -> str:
        return (f"STAGE({self.index})" if self.inner is None
                else f"STAGE({self.index}, {self.inner!r})")


def model_sharded(dim: int, axis: str = MODEL_AXIS, batch: bool = False):
    """Explicit spec with ``dim`` on ``axis`` (and dim 0 on the data
    axis when ``batch``) — the TP/ring building block."""
    entries: list = [None] * (dim + 1)
    if batch:
        if dim == 0:
            raise ValueError("dim 0 cannot carry both batch and model")
        entries[0] = DATA_AXIS
    entries[dim] = axis
    return _pspec(*entries)


# ----------------------------------------------------------------------
# resolution result + compat layer
# ----------------------------------------------------------------------
@dataclass
class ResolvedPartition:
    """One leaf's resolved placement — the spec plus the derived
    attributes the compatibility layer stamps back onto the Vector."""
    path: str
    spec: tuple                        # axis name or None a dim
    rule: str                          # matching pattern ("<scalar>")
    batch_major: bool = False
    model_shard_dim: int | None = None
    model_shard_axis: str = MODEL_AXIS
    data_shard_dim: int | None = None
    data_shard_pad: int = 0
    member_axis: bool = False
    logical_shape: tuple = ()
    #: the pipeline stage owning this leaf; None = unstaged
    stage: int | None = None

    def apply_to(self, vec) -> "ResolvedPartition":
        """Populate the legacy slot attributes FROM this resolution —
        the compatibility layer (existing readers keep working; units
        no longer write these directly)."""
        vec.model_shard_dim = self.model_shard_dim
        vec.model_shard_axis = self.model_shard_axis
        vec.data_shard_dim = self.data_shard_dim
        vec.data_shard_pad = self.data_shard_pad
        vec.member_axis = self.member_axis
        vec._partition = self
        return self

    def padded_shape(self) -> tuple:
        """:attr:`logical_shape` with the derived ZeRO-1 pad applied —
        the storage shape the allocator must use."""
        shape = list(self.logical_shape)
        if self.data_shard_dim is not None and self.data_shard_pad:
            shape[self.data_shard_dim] += self.data_shard_pad
        return tuple(shape)


# ----------------------------------------------------------------------
# the default tail — canonical slot-name coverage
# ----------------------------------------------------------------------
#: batch-major transients: the minibatch data plane plus every
#: per-sample buffer the standard units allocate (dim 0 = minibatch)
_BATCH_SLOTS = (
    r"output", r"out\d+", r"err_input\d*", r"err_output",
    r"minibatch_data", r"minibatch_labels", r"minibatch_indices",
    r"minibatch_raw", r"mask", r"max_idx", r"winners", r"input",
    r"reconstruction", r"targets", r"last_choice",
)
#: replicated persistent / host-bookkeeping state: parameters,
#: momentum (non-ZeRO-1 — the ZeRO-1 allocator declares overrides),
#: schedule tables, PRNG chains, metric accumulators
_REPLICATED_SLOTS = (
    r"weights", r"bias", r"weights_out", r"bias_out", r"vbias",
    r"weights_batch", r"acc_\w+", r"lr_state", r"rng_state",
    r"sched_\w+", r"epoch_\w+", r"n_err", r"confusion", r"coords",
    r"h_mean", r"v_mean", r"step_flags", r"anomaly_state",
    r"fault_inject", r"sdc_\w+", r"zero_mask", r"original_data",
    r"original_labels", r"minibatch_valid",
    r"pos_table", r"hits", r"metrics", r"time", r"histogram",
)


def default_rules() -> list:
    """The framework's default tail: two mutually-exclusive patterns
    over the canonical slot vocabulary.  Unit-declared overrides (TP,
    ring, ZeRO-1, population) precede these; anything matching neither
    is a hard :class:`UnmatchedLeafError` at bind time."""
    return [
        (rf"/({'|'.join(_BATCH_SLOTS)})$", BATCH),
        (rf"/({'|'.join(_REPLICATED_SLOTS)})$", REPLICATED),
    ]


# ----------------------------------------------------------------------
# the table
# ----------------------------------------------------------------------
class PartitionTable:
    """One workflow's ordered rule table.

    Two sections, matched in order: unit-declared **overrides** (exact
    anchored paths, replace-on-redeclare so re-initialization updates
    in place) then the framework's **default tail**
    (:func:`default_rules`).  ``rules`` exposes the concatenation —
    the ONE ordered table resolution walks first-match-wins.
    """

    def __init__(self, name: str = "", defaults=None) -> None:
        self.name = name
        self._overrides: list[tuple[str, object]] = []
        self._defaults: list[tuple[str, object]] = list(
            default_rules() if defaults is None else defaults)
        #: bound leaves: path → ResolvedPartition (audit + metrics)
        self.leaves: dict[str, ResolvedPartition] = {}

    # -- authoring ------------------------------------------------------
    @property
    def rules(self) -> list[tuple[str, object]]:
        return self._overrides + self._defaults

    def declare(self, pattern: str, placement) -> None:
        """Add (or replace, keeping position) an override rule."""
        for i, (pat, _) in enumerate(self._overrides):
            if pat == pattern:
                self._overrides[i] = (pattern, placement)
                return
        self._overrides.append((pattern, placement))

    def declare_leaf(self, path: str, placement) -> str:
        """Exact-path override for one leaf; returns the pattern."""
        pattern = f"^{re.escape(path)}$"
        self.declare(pattern, placement)
        return pattern

    # -- matching -------------------------------------------------------
    def match(self, path: str,
              skip_stage: bool = False) -> tuple[str, object]:
        """First matching (pattern, placement); hard error otherwise.
        ``skip_stage`` ignores :class:`Stage` tags — the fall-through
        lookup for a Stage rule with no ``inner`` placement."""
        for pattern, placement in self.rules:
            if skip_stage and isinstance(placement, Stage):
                continue
            if re.search(pattern, path):
                return pattern, placement
        raise UnmatchedLeafError(
            f"partition table '{self.name}': no rule matches leaf "
            f"'{path}' ({len(self.rules)} rules) — declare one on the "
            f"owning unit (ModuleUnit.place) or use a canonical slot "
            f"name; there is no silent replicated fallback")

    def audit(self, path: str) -> dict:
        """Every matching rule, split by section — the rule-coverage
        linter's view.  A well-formed table gives each leaf at most
        one (non-Stage) override and, when none, exactly one default
        match; :class:`Stage` tags are listed separately (``stages``)
        because a stage assignment composes WITH a placement rather
        than competing with it — at most one may match a leaf."""
        overrides, stages = [], []
        for p, pl in self._overrides:
            if re.search(p, path):
                (stages if isinstance(pl, Stage) else overrides).append(p)
        defaults = [p for p, _ in self._defaults if re.search(p, path)]
        return {"path": path, "overrides": overrides,
                "defaults": defaults, "stages": stages}

    # -- resolution -----------------------------------------------------
    def resolve(self, path: str, shape, n_data: int = 1,
                member_count: int | None = None) -> ResolvedPartition:
        """Resolve one leaf: scalar short-circuit → first match →
        placement materialized against the LOGICAL shape.  A
        :class:`Stage` match records the stage tag, then the effective
        placement is its ``inner`` (when given) or the NEXT matching
        non-Stage rule — so staging never silences the
        unmatched-leaf hard error."""
        shape = tuple(int(s) for s in shape)
        if len(shape) == 0 or int(np.prod(shape)) <= 1:
            return ResolvedPartition(path, _pspec(), "<scalar>",
                                     logical_shape=shape)
        pattern, placement = self.match(path)
        stage = None
        if isinstance(placement, Stage):
            stage = int(placement.index)
            if placement.inner is not None:
                placement = placement.inner
            else:
                pattern, placement = self.match(path, skip_stage=True)
        resolved = materialize(placement, path, shape, n_data,
                               rule=pattern)
        resolved.stage = stage
        return resolved

    # -- telemetry ------------------------------------------------------
    def _publish(self) -> None:
        from znicz_tpu_torch.observe import metrics as _metrics
        if self.name and _metrics.enabled():
            _metrics.partition_rules(self.name).set(len(self.rules))
            _metrics.partition_leaves(self.name).set(len(self.leaves))

    def dump(self) -> list[tuple[str, str]]:
        """(pattern, placement-repr) rows — table introspection for
        dryruns / multi-process agreement checks."""
        return [(pat, repr(pl)) for pat, pl in self.rules]

    def __repr__(self) -> str:
        return (f"PartitionTable('{self.name}', "
                f"{len(self._overrides)} overrides + "
                f"{len(self._defaults)} defaults, "
                f"{len(self.leaves)} leaves)")


# ----------------------------------------------------------------------
# materialization
# ----------------------------------------------------------------------
def _spec_entries(spec) -> tuple:
    try:
        return tuple(spec)
    except TypeError:
        return (spec,)


def materialize(placement, path: str, shape: tuple, n_data: int,
                rule: str = "<direct>") -> ResolvedPartition:
    """Turn a rule's placement into a :class:`ResolvedPartition`
    against the leaf's LOGICAL shape — where ZeRO-1 (dim, pad) and
    member-axis divisibility become consequences."""
    ndim = len(shape)
    if isinstance(placement, _Replicated):
        return ResolvedPartition(path, _pspec(), rule,
                                 logical_shape=shape)
    if isinstance(placement, _Batch):
        if ndim == 0:
            return ResolvedPartition(path, _pspec(), rule,
                                     logical_shape=shape)
        # full-rank spec: NamedSharding equality (and therefore the
        # jit cache key) distinguishes P('data') from P('data', None)
        # — emit exactly what the legacy attribute branch emits
        entries = [DATA_AXIS] + [None] * (ndim - 1)
        return ResolvedPartition(path, _pspec(*entries), rule,
                                 batch_major=True, logical_shape=shape)
    if isinstance(placement, Zero1):
        from znicz_tpu_torch.parallel.mesh import zero1_partition
        md = placement.model_dim
        dim, pad = zero1_partition(shape, n_data, md)
        entries: list = [None] * ndim
        if md is not None:
            entries[md] = MODEL_AXIS
        if dim is None:
            return ResolvedPartition(
                path, _pspec(*entries), rule, model_shard_dim=md,
                logical_shape=shape)
        entries[dim] = DATA_AXIS
        return ResolvedPartition(
            path, _pspec(*entries), rule, model_shard_dim=md,
            data_shard_dim=dim, data_shard_pad=pad,
            logical_shape=shape)
    if isinstance(placement, Member):
        md = placement.model_dim
        if md == 0:
            raise PartitionMismatchError(
                f"partition leaf '{path}': dim 0 is the member axis — "
                f"it cannot also carry the model axis")
        entries = [None] * ndim
        if ndim and n_data > 0 and shape[0] % n_data == 0:
            entries[0] = DATA_AXIS
        if md is not None:
            entries[md] = MODEL_AXIS
        return ResolvedPartition(
            path, _pspec(*entries), rule, model_shard_dim=md,
            member_axis=True, logical_shape=shape)
    # explicit PartitionSpec (or tuple) — derive the compat attributes
    entries = list(_spec_entries(placement))
    if len(entries) > ndim:
        raise PartitionMismatchError(
            f"partition leaf '{path}': spec {tuple(entries)} has more "
            f"entries than the {ndim}-d leaf {shape}")
    entries += [None] * (ndim - len(entries))
    batch = bool(entries) and entries[0] == DATA_AXIS
    model_dim = None
    model_axis = MODEL_AXIS
    data_dim = None
    for i, entry in enumerate(entries):
        if entry in (MODEL_AXIS, SEQ_AXIS):
            if model_dim is not None:
                raise PartitionMismatchError(
                    f"partition leaf '{path}': spec {tuple(entries)} "
                    f"shards two dims over model/seq axes — the "
                    f"compat layer carries exactly one")
            model_dim, model_axis = i, entry
        elif entry == DATA_AXIS and i > 0:
            data_dim = i
    if data_dim is not None and data_dim == model_dim:
        raise PartitionMismatchError(
            f"partition leaf '{path}': dim {data_dim} cannot carry "
            f"both the data and the model axis")
    return ResolvedPartition(
        path, _pspec(*entries), rule, batch_major=batch,
        model_shard_dim=model_dim, model_shard_axis=model_axis,
        data_shard_dim=data_dim, logical_shape=shape)


# ----------------------------------------------------------------------
# engine gate + unit-facing helpers
# ----------------------------------------------------------------------
def enabled() -> bool:
    """``root.common.engine.partition_rules`` (default ON).  OFF is
    the legacy A/B arm: declarative call sites apply the equivalent
    slot attributes directly (golden-table test pins parity)."""
    from znicz_tpu_torch.utils.config import root
    return root.common.engine.get("partition_rules", True) \
        not in (False, 0, "off", "false")


def table_for(workflow) -> PartitionTable | None:
    """The owning workflow's table, or None when rules are off / the
    container carries none (bare Vectors keep the legacy attribute
    path in ``sharding_for``)."""
    if not enabled():
        return None
    return getattr(workflow, "partition", None)


def path_of(vec, owner: str | None = None) -> str:
    """Canonical ``unit.name/slot`` leaf path from a Vector's name
    (``fc1.output`` → ``fc1/output``); bare names fall under the
    owning unit."""
    name = getattr(vec, "name", "") or ""
    if "." in name:
        head, rest = name.split(".", 1)
        return f"{head}/{rest}"
    if owner:
        return f"{owner}/{name or 'vec'}"
    return name or "vec"


def declare(unit, vec, placement, slot: str | None = None,
            logical_shape=None) -> ResolvedPartition | None:
    """Unit-facing declaration: register the leaf's rule in the
    workflow table and stamp the resolution (rules ON), or apply the
    equivalent legacy attributes directly (rules OFF).  Returns the
    resolution when the leaf's shape is known."""
    path = (f"{unit.name}/{slot}" if slot is not None
            else path_of(vec, owner=unit.name))
    device = getattr(unit, "device", None)
    n_data = getattr(device, "n_data_shards", 1) if device is not None \
        else 1
    shape = tuple(logical_shape) if logical_shape is not None else (
        tuple(vec.shape) if vec else None)
    table = table_for(unit.workflow)
    if table is None:
        # legacy arm: same decision, applied as slot attributes
        if shape is None:
            return None
        resolved = materialize(placement, path, shape, n_data)
        if vec is not None:
            apply_legacy(vec, resolved)
        return resolved
    table.declare_leaf(path, placement)
    if shape is None:
        return None
    resolved = table.resolve(path, shape, n_data=n_data)
    if not vec or tuple(vec.shape) != resolved.padded_shape():
        # declared against the logical shape before (padded)
        # allocation — the caller stamps after reset
        return resolved
    resolved.apply_to(vec)
    table.leaves[path] = resolved
    table._publish()
    return resolved


def apply_legacy(vec, resolved: ResolvedPartition) -> None:
    """Rules-off arm: the same decision expressed as the legacy slot
    attributes (``sharding_for``'s attribute branch reads these)."""
    vec.model_shard_dim = resolved.model_shard_dim
    vec.model_shard_axis = resolved.model_shard_axis
    vec.data_shard_dim = resolved.data_shard_dim
    vec.data_shard_pad = resolved.data_shard_pad
    if resolved.member_axis:
        vec.member_axis = True


# ----------------------------------------------------------------------
# this process's shard of a leaf, and the logical leaf back
# ----------------------------------------------------------------------
def _sharded_dims(resolved: ResolvedPartition, mesh) -> list:
    """``(dim, axis, pad)`` of every dim of the leaf that a mesh axis of
    size > 1 splits (the batch dim excluded: batch-major leaves are
    per-step transients, never stored)."""
    dims = []
    if resolved.model_shard_dim is not None \
            and mesh.size(resolved.model_shard_axis) > 1:
        dims.append((resolved.model_shard_dim, resolved.model_shard_axis,
                     0))
    if resolved.data_shard_dim is not None \
            and mesh.size(DATA_AXIS) > 1:
        dims.append((resolved.data_shard_dim, DATA_AXIS,
                     resolved.data_shard_pad))
    return dims


def is_sharded(resolved: ResolvedPartition | None, mesh) -> bool:
    """True when this process holds only a shard of the leaf."""
    return resolved is not None and mesh is not None \
        and bool(_sharded_dims(resolved, mesh))


def local_slice(full, resolved: ResolvedPartition, mesh):
    """This process's shard of the logical array ``full`` (a tensor):
    each sharded dim zero-padded as the placement says, then cut to
    this process's block along it."""
    import torch
    out = full
    for dim, axis, pad in _sharded_dims(resolved, mesh):
        if pad:
            widths = [0, 0] * out.dim()
            widths[2 * (out.dim() - 1 - dim) + 1] = pad
            out = torch.nn.functional.pad(out, widths)
        n = mesh.size(axis)
        block = out.shape[dim] // n
        out = out.narrow(dim, mesh.index(axis) * block, block)
    return out.contiguous()


def gather_full(local, resolved: ResolvedPartition, mesh):
    """The logical array from this process's shard ``local`` (a
    collective: every process of the axis calls it in lockstep): the
    blocks all-gathered along each sharded dim, the padding cut off."""
    import torch

    from znicz_tpu_torch.parallel.axis import all_gather_flat
    out = local
    for dim, axis, pad in reversed(_sharded_dims(resolved, mesh)):
        n = mesh.size(axis)
        moved = out.movedim(dim, 0).contiguous()
        whole = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                            dtype=moved.dtype, device=moved.device)
        all_gather_flat(whole, moved, mesh.group(axis))
        out = whole.movedim(0, dim)
        if pad:
            out = out.narrow(dim, 0, out.shape[dim] - pad)
    return out.contiguous()
