"""Multi-process bring-up from the environment or from flags (port of
``znicz_tpu/parallel/distributed.py``).

The reference starts ``jax.distributed``; the port starts
``torch.distributed``: one process a device, NCCL between CUDA
devices, gloo between CPU ranks (``-b cpu``).  The environment contract
is the reference's, and explicit arguments win over it:

- ``ZNICZ_COORDINATOR``   — ``host:port`` of process 0,
- ``ZNICZ_NUM_PROCESSES`` — the process count,
- ``ZNICZ_PROCESS_ID``    — this process's index (0 is the master).

A test may hand :func:`ensure_initialized` an ``init_method`` (a
``file://`` path) instead of a coordinator, so that no port is fixed.
On the card each process binds ``cuda:LOCAL_RANK`` (the ``LOCAL_RANK``
variable, else the process index modulo the visible devices): NCCL
refuses two ranks on one GPU.
"""

from __future__ import annotations

import datetime
import os
import time

ENV_COORDINATOR = "ZNICZ_COORDINATOR"
ENV_NUM_PROCESSES = "ZNICZ_NUM_PROCESSES"
ENV_PROCESS_ID = "ZNICZ_PROCESS_ID"


def env_spec() -> dict | None:
    """The environment's bring-up request, or None when unset."""
    coordinator = os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        return None
    spec: dict = {"coordinator_address": coordinator}
    n = os.environ.get(ENV_NUM_PROCESSES)
    if n is not None:
        spec["num_processes"] = int(n)
    pid = os.environ.get(ENV_PROCESS_ID)
    if pid is not None:
        spec["process_id"] = int(pid)
    return spec


def backend_for(device_type: str) -> str:
    """``nccl`` for CUDA devices, ``gloo`` for the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type "
                     f"'{device_type}' (cuda or cpu)")


def local_device(device_type: str):
    """This process's device: ``cuda:LOCAL_RANK`` on the card (bound as
    the current device), the CPU otherwise."""
    import torch
    if device_type != "cuda":
        return torch.device("cpu")
    import torch.distributed as dist
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available for an NCCL rank "
                           "— pass -b cpu for gloo ranks on the host")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % n
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def ensure_initialized(coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None,
                       timeout_s: float | None = None,
                       device_type: str = "cuda",
                       init_method: str | None = None) -> bool:
    """Idempotent ``torch.distributed.init_process_group`` with a
    bring-up deadline.

    Explicit arguments win; otherwise the environment contract above is
    read.  Returns True when this process belongs to an initialized
    process group (one a caller started included), False when nothing
    asked for one.  ``engine.dist_init_timeout_s`` (default 300 s; the
    ``timeout_s`` argument wins) bounds each attempt,
    ``engine.dist_init_retries`` (default 2) more attempts follow after
    ``engine.dist_init_backoff_s`` (default 2 s, doubling), and the last
    failure raises a RuntimeError naming the spec, as the reference
    does."""
    import torch.distributed as dist

    from znicz_tpu_torch.utils.config import root

    if dist.is_initialized():
        return True
    spec = env_spec() or {}
    if coordinator is not None:
        spec["coordinator_address"] = coordinator
    if num_processes is not None:
        spec["num_processes"] = num_processes
    if process_id is not None:
        spec["process_id"] = process_id
    if init_method is None:
        if not spec.get("coordinator_address"):
            return False
        init_method = f"tcp://{spec['coordinator_address']}"
    if spec.get("num_processes") is None or spec.get("process_id") is None:
        raise ValueError(
            f"distributed bring-up needs the process count and this "
            f"process's index ({ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} or "
            f"--nodes/--process-id); got {spec}")
    world, rank = int(spec["num_processes"]), int(spec["process_id"])
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    engine = root.common.engine
    timeout = float(timeout_s if timeout_s is not None
                    else engine.get("dist_init_timeout_s", 300.0))
    retries = int(engine.get("dist_init_retries", 2))
    backoff = float(engine.get("dist_init_backoff_s", 2.0))
    backend = backend_for(device_type)
    last_exc: Exception | None = None
    for attempt in range(retries + 1):
        try:
            dist.init_process_group(
                backend, init_method=init_method, world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=timeout))
            local_device(device_type)
            return True
        except (TypeError, ValueError):
            raise  # a bad spec never fixes itself
        except Exception as exc:  # timeout, refused connection, ...
            last_exc = exc
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempt < retries:
                time.sleep(backoff * (2 ** attempt))
    raise RuntimeError(
        f"torch.distributed bring-up ({backend}) failed after "
        f"{retries + 1} attempt(s) of {timeout:.0f}s each: {last_exc}.  "
        f"Spec: init_method={init_method!r}, num_processes={world}, "
        f"process_id={rank}.  Check that every process exports the SAME "
        f"{ENV_COORDINATOR} (host:port of process 0) and a distinct "
        f"{ENV_PROCESS_ID} in [0, {ENV_NUM_PROCESSES}), that process 0 "
        f"is running and its port reachable, and that no stale process "
        f"still holds the port") from last_exc


def shutdown() -> None:
    """Tear the process group down, so that the process can exit and a
    fresh :func:`ensure_initialized` start a new one: on the card once
    the device has finished and the graphs that nothing holds any more
    are destroyed (a live graph holding NCCL collectives keeps NCCL
    from destroying the communicator; the caller releases the graphs it
    holds first, as ``AcceleratedWorkflow.release_graphs`` does), then
    after a barrier, so that no process tears down while another is
    still in a collective with it."""
    import gc

    import torch
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    devices = None
    if dist.get_backend() == "nccl":
        torch.cuda.synchronize()
        gc.collect()
        devices = [torch.cuda.current_device()]
    dist.barrier(device_ids=devices)
    dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """``(process index, process count)`` of this run: ``(0, 1)`` with
    no process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
