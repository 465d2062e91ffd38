#!/usr/bin/env python3
"""Time the graphed train step with the anomaly guard off, and on with
each way of reading its state, in turns on one card.

The modes:

- ``off``: the guard and the fingerprints off;
- ``sync``: on, the decision's tick reading ``anomaly_state`` when the
  step is done (``AnomalyGuard.read_state``, the reference's read);
- ``lagged``: on, the tick reading the copy the previous tick queued
  (``AnomalyGuard.poll_state``, the port's default on the card);
- ``noread``: on, no read (``engine.anomaly_check_interval`` past the
  run).

The paths (``--paths``): ``mnist`` (``models/samples/mnist.py``, f32,
B = 100), ``alexnet`` (``chip_smoke.py``'s, bf16, B = 128) and ``seq``
(``chip_smoke.py``'s sequence stack, bf16, B = 16).  Each mode runs
twice, in the order off, sync, lagged, noread, then back; a reading is
the mean of ``--steps`` steps (a warm-up step first) between two CUDA
events, so it holds the host's stalls.  Run from the root of a checkout
on a machine with one card::

    python3 tools/guard_read_ab.py

Prints the card's name and power limit first, then a line a path: each
mode's two readings in ms a step.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

MODES = ("off", "sync", "lagged", "noread")
STEPS = {"mnist": 60, "alexnet": 12, "seq": 12}


def build(path: str, guard: bool):
    import numpy as np
    import torch
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import reset_root, root
    reset_root()
    root.common.engine.anomaly_guard = guard
    if path == "mnist":
        from znicz_tpu_torch.models.samples import mnist
        prng.seed_all(cs.SEED)
        wf = mnist.build()
        wf.initialize()
        cs.train_ahead(wf, 8)  # past the validation minibatches
    elif path == "alexnet":
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


def reading(wf, mode: str, steps: int) -> float:
    from znicz_tpu_torch.resilience.guard import AnomalyGuard
    from znicz_tpu_torch.utils.config import root
    root.common.engine.anomaly_check_interval = \
        10 ** 9 if mode == "noread" else 1
    lagged = AnomalyGuard._lagged
    if mode == "sync":
        AnomalyGuard._lagged = lambda self: False
    try:
        return cs.turn_ms(wf, steps)[1]
    finally:
        AnomalyGuard._lagged = lagged
        root.common.engine.anomaly_check_interval = 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", nargs="+", choices=list(STEPS),
                    default=list(STEPS))
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cs.set_graphs(True)
    for path in args.paths:
        wfs = {False: build(path, False), True: build(path, True)}
        got = {mode: [] for mode in MODES}
        for mode in MODES + MODES[::-1]:
            got[mode].append(reading(wfs[mode != "off"], mode,
                                     STEPS[path]))
        print(f"{path}, ms a graphed train step (mean of {STEPS[path]}, "
              f"two turns): " + "; ".join(
                  f"{mode} " + " / ".join(f"{v:.4f}" for v in got[mode])
                  for mode in MODES), flush=True)
        del wfs


if __name__ == "__main__":
    main()
