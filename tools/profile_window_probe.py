#!/usr/bin/env python3
"""Count the ``torch.profiler`` windows that lose kernel records of a
graphed train step, with and without idle margins around the window.

``chip_smoke.py`` checks, in a profiler window over a few graphed train
steps, that the launches its kernel wrappers counted are the kernels
the profiler saw run.  The trace keeps only the device activity it
places inside its window, and a CUDA-graph replay starts its first
kernels a few microseconds after the host enqueues it, so a window that
opens straight into a replay can lose the replay's opening kernels.
This probe trains the full-width bf16 sequence stack of
``chip_smoke.py`` (attention, 8 heads of 64 → layer_norm → softmax over
8 classes, T = 2048, D = 512, B = 16) graphed, and for ``--seconds``
alternates two windows of 3 train steps, one with no margin and one
with ``chip_smoke.PROFILE_MARGIN_S`` of idle at each end, with 20 steps
outside any window between them (as the script runs between its
windows).  A window misses when a hand-written kernel (the flash
kernels, layer norm, softmax + argmax) shows fewer than one record a
step.  Run it from the root of a checkout on a machine with one card::

    python3 tools/profile_window_probe.py --seconds 220

Prints each window that missed (its time and kernel counts), then the
count for each margin, the card's name, driver and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the kernels a window is checked for, by a substring of their names
KERNELS = ("flash_fwd_kernel", "flash_bwd_kernel<false",
           "flash_bwd_kernel<true", "ln_fwd_reg_kernel", "ln_bwd_reg_kernel",
           "ln_bwd_reg_fold_kernel", "softmax_argmax_reg_kernel")
STEPS = 3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=220.0)
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from znicz_tpu_torch.ops import _cuda
    if not torch.cuda.is_available():
        print("profile_window_probe: no CUDA device", file=sys.stderr)
        return 2
    _cuda.build_all()
    rng = np.random.default_rng(cs.SEED + 2)
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(
        4 * cs.BATCH, cs.SEQ, cs.DIM)).astype(np.float32)).to(torch.bfloat16)
    y = rng.integers(0, cs.CLASSES, size=4 * cs.BATCH).astype(np.int32)
    wf = cs.make_trainer(x, y, cs.BATCH)
    for _ in range(4):
        wf.step()
    torch.cuda.synchronize()

    def window(margin: float) -> dict:
        """Records of each checked kernel in one window of STEPS steps."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(STEPS):
                wf.step()
            torch.cuda.synchronize()
            time.sleep(margin)
        seen = dict.fromkeys(KERNELS, 0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                for name in KERNELS:
                    if name in e.key:
                        seen[name] += e.count
        return seen

    margins = (0.0, cs.PROFILE_MARGIN_S)
    runs = dict.fromkeys(margins, 0)
    misses = dict.fromkeys(margins, 0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for margin in margins:
            seen = window(margin)
            runs[margin] += 1
            if min(seen.values()) < STEPS:
                misses[margin] += 1
                print(f"t = {time.perf_counter() - t0:.0f} s, margin "
                      f"{margin} s: missed {seen}", flush=True)
        for _ in range(20):
            wf.step()
    for margin in margins:
        print(f"margin {margin} s: {misses[margin]} of {runs[margin]} "
              f"windows missed a record")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,driver_version,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
