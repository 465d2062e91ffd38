#!/usr/bin/env python3
"""Time the serving latency of several checkouts on one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given, with that
checkout's ``znicz_tpu_torch`` package and this checkout's
``chip_smoke.py`` bundle: the full-width bf16 scorer of phase 3
(attention, 8 heads of 64 → layer_norm → softmax over 8 classes,
T = 2048, D = 512, weights from a fixed seed) behind
``ServingEngine(max_batch=16, max_delay_ms=2)``.  After one request of
each size, six rounds of phase 3's closed loop (``chip_smoke.closed_loop``:
30 sequential requests of 1, 3 and 16 rows in turn, the 2 ms admission
window included), each printed as its p50 latency.  The p50 spreads by
about ±0.7 ms on one card, so list the checkouts again for more readings.  Give the checkouts in turns
to see the spread on one card, e.g. with the parent unpacked into
``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/serve_ab.py build/parent . . build/parent

Prints one line a checkout, then the card's name and power limit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 6


def time_checkout(root: str) -> None:
    """Prints the p50 latency, in ms, of each round of the checkout at
    ``root``: this process imports that checkout's package."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    from znicz_tpu_torch.serving import ServingEngine
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(smoke.SEED + 1)
    x = rng.normal(0.0, 0.3, size=(smoke.BATCH, smoke.SEQ, smoke.DIM)
                   ).astype(np.float32)
    p50 = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scorer.npz")
        smoke.write_scorer_bundle(path)
        with ServingEngine(path, max_batch=smoke.BATCH,
                           max_delay_ms=2.0) as eng:
            for n in (1, 3, 16):
                eng(x[:n], timeout=300)
            for _ in range(ROUNDS):
                lat, _ = smoke.closed_loop(eng, x)
                p50.append(1e3 * lat[len(lat) // 2])
    print(f"serving p50 (1/3/16 rows, T={smoke.SEQ}, D={smoke.DIM}) from "
          f"{root}: " + " ".join(f"{ms:.3f}" for ms in p50) + " ms",
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="+", help="checkout roots, in turn")
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)  # time one root, here
    args = parser.parse_args()
    if args.one:
        time_checkout(args.roots[0])
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
