"""Process-level work sharding for population and ensemble evaluation
(port of ``znicz_tpu/parallel/process_shard.py``).

Every process holds the same deterministic work list, evaluates the
round-robin slice ``work[process_index::process_count]`` on its own
device, and the scores are merged with one all-gather over the world
group.  One process degrades to plain serial evaluation with no
collective.  Transport is bit-exact: float64 travels as float64 (gloo
and NCCL both carry it), so a multi-process result cannot drift from a
one-process one.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.parallel.distributed import process_info

__all__ = ["process_info", "allgather_sum", "broadcast_from_zero",
           "merge_sharded_scores", "merge_round_robin"]


def _wire_device():
    """Where a host array crosses the wire: the current card under NCCL,
    the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _exact_allgather(arr: np.ndarray) -> np.ndarray:
    """``(process_count, *arr.shape)``: row ``p`` is process ``p``'s
    ``arr`` (lockstep; every process passes the same shape and
    dtype)."""
    import torch.distributed as dist
    arr = np.ascontiguousarray(arr)
    _, count = process_info()
    if count == 1:
        return arr[None].copy()
    dev = _wire_device()
    local = torch.from_numpy(arr.copy()).to(dev)
    parts = [torch.empty_like(local) for _ in range(count)]
    dist.all_gather(parts, local)
    return np.stack([p.cpu().numpy() for p in parts])


def merge_sharded_scores(scores: np.ndarray, owner_stride: int
                         ) -> np.ndarray:
    """All-gather a round-robin-sharded score vector: ``scores[i]`` is
    valid only on process ``i % owner_stride``; returns the merged
    vector, slot ``i`` from its owner."""
    gathered = _exact_allgather(np.asarray(scores, np.float64))
    merged = np.empty_like(gathered[0])
    for i in range(merged.shape[0]):
        merged[i] = gathered[i % owner_stride, i]
    return merged


def merge_round_robin(local_values, pidx: int, pcount: int,
                      n: int) -> np.ndarray:
    """Merge per-job values when job ``i`` lives on process ``i %
    pcount`` at local slot ``i // pcount``."""
    scores = np.full(n, np.nan)
    scores[pidx::pcount] = local_values
    return merge_sharded_scores(scores, pcount)


def allgather_sum(partial: np.ndarray) -> np.ndarray:
    """Sum a per-process partial array over the processes (lockstep),
    on the host, in float64, in process order."""
    gathered = _exact_allgather(np.asarray(partial, np.float64))
    return gathered.sum(axis=0)


def broadcast_from_zero(arr: np.ndarray) -> np.ndarray:
    """Process 0's array on every process (lockstep, bit-exact)."""
    import torch.distributed as dist
    arr = np.ascontiguousarray(arr)
    if process_info()[1] == 1:
        return arr.copy()
    t = torch.from_numpy(arr.copy()).to(_wire_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
