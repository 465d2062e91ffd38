"""The device mesh and the sharding arithmetic (port of
``znicz_tpu/parallel/mesh.py``).

The reference is one controller over a ``jax.sharding.Mesh`` whose
collectives GSPMD inserts.  The port is one process a device, and
:class:`Mesh` is this process's view of the global grid: a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``data``, ``model`` and, with ``n_seq > 1``, ``seq``), used for
its process groups only.  The units write each collective out
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
    """This process's place in a ``(data, model[, seq])`` grid of
    processes, one device each.

    ``shape`` maps axis name → size (ordered as the grid); ``groups``
    each axis's process group among the processes that share this
    process's other coordinates; ``coords`` this process's index along
    each axis.  Built by :func:`make_mesh` after
    :func:`~znicz_tpu_torch.parallel.distributed.ensure_initialized`."""

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
        if self.device_type == "cuda":
            torch.cuda.synchronize(dev)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, at {self.coords})"


def make_mesh(n_data: int | None = None, n_model: int = 1, n_seq: int = 1,
              device_type: str = "cuda", n_pipe: int = 1) -> Mesh:
    """A ``(data, model[, seq])`` mesh over the processes of the
    initialized process group, as the reference's ``make_mesh`` over
    its devices: ``n_data=None`` puts every remaining process on the
    data axis, and ``n_data × n_model × n_seq`` must be the process
    count.  The temporal pipeline runs in one process (no ``pipe``
    axis): ``n_pipe`` > 1 raises."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.ensure_initialized)")
    if n_pipe != 1:
        raise ValueError("a pipe axis across processes is not offered: "
                         "the pipeline is temporal, in one process "
                         "(StandardWorkflow.run_pipelined)")
    world = dist.get_world_size()
    if n_data is None:
        if world % (n_model * n_seq):
            raise ValueError(f"{world} processes do not divide into "
                             f"n_model={n_model} × n_seq={n_seq}")
        n_data = world // (n_model * n_seq)
    if n_data * n_model * n_seq != world:
        raise ValueError(f"mesh {n_data} × {n_model} × {n_seq} != "
                         f"{world} processes")
    shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
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
    """The sub-mesh of pipeline stage ``stage``: a mesh without a
    ``pipe`` axis (every mesh here: the pipeline is temporal) is
    returned unchanged, as in the reference."""
    names = getattr(mesh, "axis_names", ())
    if PIPE_AXIS not in names:
        return mesh
    raise ValueError("a pipe axis across processes is not offered")
