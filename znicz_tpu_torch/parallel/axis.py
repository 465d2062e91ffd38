"""Mesh-axis names and the data-axis seam (port of
``znicz_tpu/parallel/axis.py``).

The reference names its mesh axes once and lets a mapped context decide
whether ``maybe_pmean``/``maybe_psum`` are all-reduces.  Here the
context holds a ``torch.distributed`` process group: inside
:func:`data_axis` with a group, :func:`maybe_psum` and
:func:`maybe_pmean` are in-place all-reduces over it (NCCL on the card,
gloo on the CPU, each captured into a CUDA graph like any kernel when
the region captures); with no group they return their argument
untouched.  The region (``JitRegion``) enters the data axis of its
device's mesh around every step, so the backward units' gradient fold
(``GradientDescentBase.apply_param``) sits where the reference's
``maybe_pmean`` does.
"""

from __future__ import annotations

import contextlib
import warnings
from contextvars import ContextVar

import torch

# Every supported torch has these two collectives under these names;
# newer releases deprecate them for names that older ones lack.
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: sequence parallelism (the ring), distinct from data and model
SEQ_AXIS = "seq"
#: pipeline stages
PIPE_AXIS = "pipe"

_active_data_axis: ContextVar = ContextVar("znicz_tpu_torch_data_axis",
                                           default=None)


def current_data_axis():
    """The process group of the data axis the enclosing step runs under,
    or None."""
    return _active_data_axis.get()


@contextlib.contextmanager
def data_axis(group):
    """Run the enclosed work under the data axis ``group`` (None: no
    data axis)."""
    token = _active_data_axis.set(group)
    try:
        yield
    finally:
        _active_data_axis.reset(token)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (a contiguous copy first
    when ``x`` is not contiguous); returns the summed tensor."""
    import torch.distributed as dist
    if not x.is_contiguous():
        x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def maybe_psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data axis when inside one, else ``x``."""
    group = _active_data_axis.get()
    if group is None:
        return x
    return all_reduce(x, group)


def data_axis_size() -> int:
    """Processes of the data axis the enclosing step runs under (1
    outside one): the factor from a process's rows to the global
    batch's."""
    group = _active_data_axis.get()
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def maybe_psum_all(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each of ``xs`` summed over the data axis when inside one (one
    all-reduce of their f32 concatenation), else ``xs`` unchanged."""
    if _active_data_axis.get() is None:
        return xs
    flat = maybe_psum(torch.cat([x.reshape(-1).float() for x in xs]))
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return tuple(out)


def maybe_pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data axis when inside one, else ``x``."""
    group = _active_data_axis.get()
    if group is None:
        return x
    import torch.distributed as dist
    return all_reduce(x, group) / dist.get_world_size(group)


def all_gather_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` ← every member's ``x`` along dim 0, in rank order."""
    import torch.distributed as dist
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)


def reduce_scatter_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` ← this member's block of dim 0 of ``x`` summed over
    ``group``."""
    import torch.distributed as dist
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
