"""The kernel wrappers' launch counters, as one registry.

Every wrapper of a hand-written kernel counts its launches in Python:
``fn.launches`` in all and ``fn.launches_by_*`` split by route, dtype,
shape and so on (:mod:`~znicz_tpu_torch.ops.fused_kernels`,
:mod:`~znicz_tpu_torch.ops.flash_attention`).  A replayed CUDA graph
runs no Python, so a region (:mod:`znicz_tpu_torch.accelerated_units`)
takes a :func:`snapshot` before it captures a step, keeps the
:func:`delta` the capture counted, :func:`restore`\\ s the counters (the
capture launched nothing), and :func:`add`\\ s the delta once a replay.
"""

from __future__ import annotations

import copy

_COUNTED: list = []


def register(*fns) -> None:
    """Count ``fns``' launches through the registry."""
    for fn in fns:
        if fn not in _COUNTED:
            _COUNTED.append(fn)


def _splits(fn) -> list[str]:
    return [name for name in vars(fn) if name.startswith("launches_by_")]


def snapshot() -> list:
    """Every registered counter, copied."""
    return [(fn, fn.launches,
             {name: copy.copy(getattr(fn, name)) for name in _splits(fn)})
            for fn in _COUNTED]


def delta(before: list) -> list:
    """What each counter gained since ``before``."""
    out = []
    for fn, n, splits in before:
        gained = {}
        for name in _splits(fn):
            now, was = getattr(fn, name), splits.get(name, {})
            gained[name] = {k: v - was.get(k, 0) for k, v in now.items()
                            if v != was.get(k, 0)}
        out.append((fn, fn.launches - n, gained))
    return out


def restore(before: list) -> None:
    """Every counter back to ``before``, in place."""
    for fn, n, splits in before:
        fn.launches = n
        for name, was in splits.items():
            now = getattr(fn, name)
            for key in list(now):
                if key not in was:
                    del now[key]
            for key, value in was.items():  # (Counter.update would add)
                now[key] = value


def add(gained: list, times: int = 1) -> None:
    """``times`` × a :func:`delta` onto the counters."""
    for fn, n, splits in gained:
        if n:
            fn.launches += n * times
        for name, keys in splits.items():
            counts = getattr(fn, name)
            for key, v in keys.items():
                counts[key] = counts.get(key, 0) + v * times
