#!/usr/bin/env python3
"""Time the full-width sequence-stack train step of several checkouts on
one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given, with that
checkout's ``znicz_tpu_torch`` package and this checkout's
``chip_smoke.py`` trainer: the stack of ``benchmarks/seq_bench.py``
(attention, 8 heads of 64 → layer_norm → softmax over 8 classes, B = 16,
T = 2048, D = 512, momentum SGD, data from a fixed seed) in
``--precision`` (float32, the default precision, unless told otherwise).
Each checkout runs 2 warm-up steps, then three runs of 10 steps between
CUDA events.  Give the checkouts in turns to see the spread on one card,
e.g. with the parent unpacked into ``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/seq_step_ab.py build/parent . . build/parent

Prints one line a checkout, then the card's name and power limit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_checkout(root: str, precision: str) -> None:
    """Prints three mean step times, in ms, of the checkout at ``root``:
    this process imports that checkout's package."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(smoke.SEED + 2)
    n = 4 * smoke.BATCH
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(n, smoke.SEQ, smoke.DIM))
                         .astype(np.float32)).to(getattr(torch, precision))
    y = rng.integers(0, smoke.CLASSES, size=n).astype(np.int32)
    wf = smoke.make_trainer(x, y, smoke.BATCH, precision=precision)
    times = [smoke.timed_steps(wf, 2 if i == 0 else 0, 10) for i in range(3)]
    print(f"step (B={smoke.BATCH}, T={smoke.SEQ}, D={smoke.DIM}, "
          f"{smoke.HEADS} heads) {precision} from {root}: "
          + " ".join(f"{ms:.3f}" for ms in times) + " ms", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="+", help="checkout roots, in turn")
    parser.add_argument("--precision", choices=("float32", "bfloat16"),
                        default="float32",
                        help="the stack's precision (default float32)")
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)  # time one root, here
    args = parser.parse_args()
    if args.one:
        time_checkout(args.roots[0], args.precision)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one", "--precision",
                        args.precision, root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
