"""The device mesh and the sharding arithmetic (port of
``znicz_tpu/parallel/mesh.py``).

The reference is one controller over a ``jax.sharding.Mesh`` whose
collectives GSPMD inserts.  The port is one process a device, and
:class:`Mesh` is this process's view of the global grid: a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``data``, ``model`` and, with ``n_seq > 1``, ``seq``; with
``n_pipe > 1`` a leading ``pipe``), used for its process groups only.
A pipe axis gives each pipeline stage a contiguous block of ranks and
one process group over it; :func:`mesh_for_stage` is stage k's
``(data, model[, seq])`` mesh.  The pipeline executor stays temporal,
in one process, as the reference's is.  The units write each collective out
themselves (the gradient fold, Megatron's column→row pair, the ring's
rotation, ZeRO-1's reduce-scatter and all-gather) on the group of the
axis the reference's placement names.

A partition spec here is a plain tuple, one entry a dim: an axis name
or None.
"""

from __future__ import annotations

from znicz_tpu_torch.parallel.axis import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                           SEQ_AXIS)


class Mesh:
    """This process's place in a ``([pipe, ]data, model[, seq])`` grid of
    processes, one device each.

    ``shape`` maps axis name → size (ordered as the grid); ``groups``
    each axis's process group among the processes that share this
    process's other coordinates; ``coords`` this process's index along
    each axis; ``ranks`` the grid of global ranks (nested lists, the
    ranks in row-major order).  With a ``pipe`` axis, ``stage_groups``
    holds one process group a stage over its block of ranks (a process
    outside the block holds no group of it).  Built by :func:`make_mesh`
    after :func:`~znicz_tpu_torch.parallel.distributed.ensure_initialized`;
    :func:`mesh_for_stage` gives a stage's mesh."""

    def __init__(self, shape: dict, device_type: str) -> None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.device_type = device_type
        self.device_mesh = init_device_mesh(
            device_type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        self.groups = {ax: self.device_mesh.get_group(ax)
                       for ax in self.axis_names}
        self.coords = {ax: int(self.device_mesh.get_local_rank(ax))
                       for ax in self.axis_names}
        self.rank = dist.get_rank()
        self.ranks = self.device_mesh.mesh.tolist()
        #: stage → the process group over its block of ranks (with a
        #: pipe axis; every process makes each group, in stage order)
        self.stage_groups = {}
        if PIPE_AXIS in self.shape:
            for k, block in enumerate(self.ranks):
                self.stage_groups[k] = dist.new_group(
                    sorted(_flat(block)))
        self.warm_up()

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def warm_up(self) -> None:
        """One all-reduce on every group: NCCL starts its communicators
        lazily, and a first collective inside a CUDA-graph capture
        fails."""
        import torch
        import torch.distributed as dist
        if self.device_type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        x = torch.ones(1, device=dev)
        dist.all_reduce(x)
        for group in self.groups.values():
            dist.all_reduce(x, group=group)
        k = self.coords.get(PIPE_AXIS)
        if k is not None:
            dist.all_reduce(x, group=self.stage_groups[k])
        if self.device_type == "cuda":
            torch.cuda.synchronize(dev)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, at {self.coords})"


class StageMesh:
    """Pipeline stage k's ``(data, model[, seq])`` mesh: the block of the
    pipe mesh's grid at pipe index k (:func:`mesh_for_stage`).  It reads
    as a :class:`Mesh` (``shape``, ``axis_names``, ``size``, ``index``,
    ``group``) over the stage's processes; ``block_group`` is the one
    group over them all.  ``member`` is False in a process of another
    stage, which holds no group of this one (``group`` None, ``index``
    raises)."""

    def __init__(self, mesh: Mesh, stage: int) -> None:
        if not 0 <= stage < mesh.shape[PIPE_AXIS]:
            raise ValueError(f"stage {stage} not on a pipe axis of "
                             f"{mesh.shape[PIPE_AXIS]}")
        self.stage = stage
        self.shape = {ax: n for ax, n in mesh.shape.items()
                      if ax != PIPE_AXIS}
        self.axis_names = tuple(self.shape)
        self.device_type = mesh.device_type
        self.ranks = mesh.ranks[stage]
        self.member = mesh.coords[PIPE_AXIS] == stage
        self.rank = mesh.rank
        self.block_group = mesh.stage_groups[stage] if self.member \
            else None
        self.groups = {ax: mesh.groups[ax] for ax in self.axis_names} \
            if self.member else {}
        self.coords = {ax: mesh.coords[ax] for ax in self.axis_names} \
            if self.member else {}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        if not self.member:
            raise ValueError(f"process {self.rank} is not on stage "
                             f"{self.stage}")
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return (f"StageMesh(stage {self.stage}, {self.shape}, ranks "
                f"{sorted(_flat(self.ranks))})")


def _flat(nested) -> list:
    """The ints of a nested list, in order."""
    if isinstance(nested, list):
        return [r for item in nested for r in _flat(item)]
    return [int(nested)]


def make_mesh(n_data: int | None = None, n_model: int = 1, n_seq: int = 1,
              device_type: str = "cuda", n_pipe: int = 1) -> Mesh:
    """A ``([pipe, ]data, model[, seq])`` mesh over the processes of the
    initialized process group, as the reference's ``make_mesh`` over
    its devices: ``n_data=None`` puts every remaining process on the
    data axis, and ``n_pipe × n_data × n_model × n_seq`` must be the
    process count.  ``n_pipe > 1`` puts a leading ``pipe`` axis first,
    the slowest-varying, so each stage holds a contiguous block of
    ranks (:func:`mesh_for_stage`)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.ensure_initialized)")
    world = dist.get_world_size()
    if n_data is None:
        if world % (n_model * n_seq * n_pipe):
            raise ValueError(f"{world} processes do not divide into "
                             f"n_model={n_model} × n_seq={n_seq} × "
                             f"n_pipe={n_pipe}")
        n_data = world // (n_model * n_seq * n_pipe)
    if n_pipe * n_data * n_model * n_seq != world:
        raise ValueError(f"mesh {n_pipe} × {n_data} × {n_model} × {n_seq} "
                         f"!= {world} processes")
    shape = {PIPE_AXIS: n_pipe} if n_pipe > 1 else {}
    shape.update({DATA_AXIS: n_data, MODEL_AXIS: n_model})
    if n_seq > 1:
        shape[SEQ_AXIS] = n_seq
    return Mesh(shape, device_type)


def spec_divides(mesh, shape, spec) -> bool:
    """True when every sharded dim of ``shape`` splits evenly over its
    axis (``mesh`` may be a :class:`Mesh` or an axis-size dict)."""
    sizes = getattr(mesh, "shape", mesh)
    for dim, axis in enumerate(spec):
        if axis is None or dim >= len(shape):
            continue
        for name in (axis,) if isinstance(axis, str) else tuple(axis):
            if shape[dim] % sizes[name]:
                return False
    return True


def shard_shape(mesh, shape, spec) -> tuple:
    """The per-process shard of ``shape`` under ``spec`` (assumes
    :func:`spec_divides`)."""
    sizes = getattr(mesh, "shape", mesh)
    out = list(shape)
    for dim, axis in enumerate(spec):
        if axis is None or dim >= len(out):
            continue
        for name in (axis,) if isinstance(axis, str) else tuple(axis):
            out[dim] //= sizes[name]
    return tuple(out)


def zero1_choice(device) -> bool:
    """``root.common.engine.zero1`` against a device: auto (the default)
    turns ZeRO-1 on for a data axis of 2 or more; ``False`` (or
    ``"off"``) keeps the replicated update; a host-only device or one
    without a mesh never shards."""
    from znicz_tpu_torch.utils.config import root
    if device is None or getattr(device, "is_host_only", False):
        return False
    mesh = getattr(device, "mesh", None)
    if mesh is None or mesh.size(DATA_AXIS) < 2:
        return False
    gate = root.common.engine.get("zero1", "auto")
    return gate not in (False, 0, "off", "false")


def zero1_partition(shape, n_shards: int,
                    model_shard_dim: int | None = None
                    ) -> tuple[int | None, int]:
    """``(dim, pad)`` of a parameter-shaped tensor in the ZeRO-1 update
    (the reference's, copied): the largest dim that ``n_shards``
    divides (pad 0), else the largest dim padded up to a multiple;
    never ``model_shard_dim``; ``(None, 0)`` with nothing to shard."""
    if n_shards < 2:
        return None, 0
    candidates = [(size, d) for d, size in enumerate(shape)
                  if d != model_shard_dim and size > 0]
    if not candidates:
        return None, 0
    even = [(size, d) for size, d in candidates if size % n_shards == 0]
    if even:
        size, dim = max(even, key=lambda t: (t[0], -t[1]))
        return dim, 0
    size, dim = max(candidates, key=lambda t: (t[0], -t[1]))
    return dim, (-size) % n_shards


def mesh_for_stage(mesh, stage: int):
    """The ``(data, model[, seq])`` mesh of pipeline stage ``stage``
    (a :class:`StageMesh`: the pipe mesh's block at pipe index
    ``stage``); a mesh without a ``pipe`` axis is returned unchanged,
    as in the reference."""
    names = getattr(mesh, "axis_names", ())
    if PIPE_AXIS not in names:
        return mesh
    return StageMesh(mesh, stage)
