#!/usr/bin/env python3
"""Time the graphed train step of the training paths of several
checkouts on one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given, with that
checkout's ``znicz_tpu_torch`` package and this checkout's
``chip_smoke.py`` builders, every region a CUDA graph (the port's way on
the card).  The paths (``--paths``, all by default):

- ``cifar``: ``models/samples/cifar.py`` (f32, B = 100), four readings
  of 20 train steps;
- ``alexnet``: phase 5's AlexNet (bf16, B = 128), four of 5 steps;
- ``seq``: the bf16 sequence stack of phase 4 (B = 16, T = 2048,
  D = 512), four of 5 steps;
- ``mnist``: ``models/samples/mnist.py`` (f32, B = 100), four of 20;
- ``wine``: ``models/samples/wine.py`` (f32, B = 10) with
  ``chip_smoke.WINE_SCHEDULE`` and without a schedule, ten readings of
  10 steps each, the two in turns.

A path the checkout lacks is skipped.  Give the checkouts in turns to
see the spread on one card, e.g. with the parent unpacked into
``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/step_ab.py build/parent . . build/parent

Prints one line a checkout (ms a train step, each reading), then the
card's name and power limit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("cifar", "alexnet", "seq", "mnist", "wine")


def _sample(name: str):
    try:
        return importlib.import_module(
            f"znicz_tpu_torch.models.samples.{name}")
    except ImportError:
        return None


def time_checkout(root: str, paths: list[str]) -> None:
    """Prints the graphed step times of ``paths`` in the checkout at
    ``root``: this process imports that checkout's package."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from znicz_tpu_torch.ops import _cuda
    _cuda.build_all()  # every source at once, before any timing
    out = {}
    if "cifar" in paths:
        wf = smoke.make_mlp(_sample("cifar"), snapshotter_config=None)
        out["cifar"] = []
        for _ in range(4):
            smoke.train_ahead(wf, 22)
            out["cifar"].append(smoke.timed_steps(wf, 2, 20))
        del wf
    if "alexnet" in paths:
        wf = smoke.make_alexnet(smoke.ALEX_BATCH, 24 * smoke.ALEX_BATCH)
        out["alexnet"] = [smoke.timed_steps(wf, 2 if i == 0 else 0, 5)
                          for i in range(4)]
        del wf
    if "seq" in paths:
        rng = np.random.default_rng(smoke.SEED + 2)
        x = torch.from_numpy(rng.normal(
            0.0, 0.3, size=(4 * smoke.BATCH, smoke.SEQ, smoke.DIM))
            .astype(np.float32)).to(torch.bfloat16)
        y = rng.integers(0, smoke.CLASSES, size=4 * smoke.BATCH).astype(
            np.int32)
        wf = smoke.make_trainer(x, y, smoke.BATCH)
        out["seq"] = [smoke.timed_steps(wf, 2 if i == 0 else 0, 5)
                      for i in range(4)]
        del wf
    mnist, wine = _sample("mnist"), _sample("wine")
    if "mnist" in paths and mnist is not None:
        wf = smoke.make_mlp(mnist)
        out["mnist"] = []
        for _ in range(4):
            smoke.train_ahead(wf, 22)
            out["mnist"].append(smoke.timed_steps(wf, 2, 20))
        del wf
    if "wine" in paths and wine is not None:
        runs = {"wine_none": smoke.make_mlp(wine, max_epochs=10 ** 6),
                "wine_schedule": smoke.make_mlp(
                    wine, lr_adjuster_config=smoke.WINE_SCHEDULE,
                    max_epochs=10 ** 6)}
        order = list(runs)
        for name in order:
            out[name] = []
        for i in range(10):
            for name in (order if i % 2 == 0 else order[::-1]):
                smoke.train_ahead(runs[name], 12)
                out[name].append(smoke.timed_steps(runs[name], 2, 10))
    print(f"graphed train step from {root}, ms: " + "; ".join(
        f"{name} " + " ".join(f"{ms:.4f}" for ms in times)
        + f" (median {sorted(times)[len(times) // 2]:.4f})"
        for name, times in out.items()), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="+", help="checkout roots, in turn")
    parser.add_argument("--paths", default=",".join(PATHS),
                        help=f"comma-separated, of {', '.join(PATHS)}")
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    paths = args.paths.split(",")
    if args.one:
        time_checkout(args.roots[0], paths)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--paths", args.paths, root], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
