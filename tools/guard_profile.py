#!/usr/bin/env python3
"""Split what the anomaly guard adds to a graphed train step on the card,
kernel by kernel.

Builds ``chip_smoke.py``'s full-width AlexNet (bf16, B = 128) and
sequence stack (bf16, B = 16, T = 2048, D = 512) twice each, with the
guard and the fingerprints on (the default) and off, warms each up
graphed, then profiles ``--steps`` graphed steps of each with
``torch.profiler`` and prints, a step: the kernels' device time and
count of each, and the kernels by name whose time the guard changes
most.  Run from the root of a checkout on a machine with one card::

    python3 tools/guard_profile.py --steps 5

Prints the card's name and power limit first.
"""

import argparse
import collections
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def build(path: str, guard: bool):
    from znicz_tpu_torch.utils.config import root
    root.common.engine.anomaly_guard = guard
    if path == "alexnet":
        wf = cs.make_alexnet(cs.ALEX_BATCH, 8 * cs.ALEX_BATCH)
    else:
        rng = np.random.default_rng(cs.SEED + 20)
        x = torch.from_numpy(rng.normal(0.0, 0.3, size=(
            4 * cs.BATCH, cs.SEQ, cs.DIM)).astype(np.float32)).to(
                torch.bfloat16)
        y = rng.integers(0, cs.CLASSES, size=4 * cs.BATCH).astype(np.int32)
        wf = cs.make_trainer(x, y, cs.BATCH)
    root.common.engine.anomaly_guard = True
    return wf


def kernels_a_step(wf, steps: int) -> dict:
    """``{kernel name: (ms a step, launches a step)}`` over ``steps``
    graphed steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        wf.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            wf.step()
        torch.cuda.synchronize()
    spans = {u.name for u in wf.units}
    out = collections.defaultdict(lambda: [0.0, 0.0])
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key in spans \
                or e.key.startswith(("workflow:", "chunk:", "capture:")):
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        out[e.key][0] += ms / steps
        out[e.key][1] += e.count / steps
    return dict(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--paths", nargs="+", default=["alexnet", "seq"],
                    choices=["alexnet", "seq"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cs.set_graphs(True)
    for path in args.paths:
        got = {}
        for guard in (True, False):
            wf = build(path, guard)
            got[guard] = kernels_a_step(wf, args.steps)
            del wf
            torch.cuda.empty_cache()
        for guard in (True, False):
            ms = sum(v[0] for v in got[guard].values())
            n = sum(v[1] for v in got[guard].values())
            print(f"{path} guard {'on' if guard else 'off'}: kernels "
                  f"{ms:.4f} ms, {n:.0f} launches a step", flush=True)
        names = set(got[True]) | set(got[False])
        diff = sorted(
            ((got[True].get(k, [0, 0])[0] - got[False].get(k, [0, 0])[0],
              got[True].get(k, [0, 0])[1] - got[False].get(k, [0, 0])[1],
              k) for k in names), reverse=True)
        for d_ms, d_n, key in diff[:args.top]:
            print(f"  {d_ms:+.4f} ms, {d_n:+.0f} launches a step: "
                  f"{key[:110]}", flush=True)


if __name__ == "__main__":
    main()
