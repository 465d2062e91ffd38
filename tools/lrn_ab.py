#!/usr/bin/env python3
"""Time the LRN kernels (B1, B2) of several checkouts on one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given:
``lrn_forward`` and ``lrn_backward`` at AlexNet's two LRN shapes, after
conv1 (128·55·55, 96) and after conv2 (128·27·27, 256), in bf16 with
n = 5, α = 1e-4, β = 0.75, k = 2, as ``chip_smoke.py`` phase 2 times
them.  Each (kernel, shape) is timed as three runs, each of 21 calls
captured in a CUDA graph and replayed between CUDA events (at conv2's
shape the wrapper's enqueue comes near the kernel's time, so calls
launched one by one may time the host); the calls rotate over three
copies of their inputs, since conv2's 47.8 MB input would otherwise
stay in the 50 MB L2.  After the kernels, PyTorch's ``clone`` and
``add`` at the same shapes, which move B1's and B2's bytes (read one
array and write one; read two and write one): a yardstick of what
streaming those bytes costs on the card.  The graphs, the rotation and
the AlexNet net come from this checkout's ``chip_smoke.py``.  With
``--step``, each checkout also times the full-width AlexNet train step
(bf16, B = 128, ``models/samples/alexnet.py`` through
``chip_smoke.make_alexnet`` and that checkout's package): 2 warm-up
steps, then three runs of 10 steps between CUDA events.  Give the
checkouts in turns to see the spread on one card, e.g. with the parent
unpacked into ``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/lrn_ab.py --step build/parent . . build/parent

Prints one line a checkout and (kernel, shape), one a checkout for the
step, then the card's name and power limit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name → rows, channels: AlexNet's LRN inputs at B = 128
SHAPES = {"conv1": (128 * 55 * 55, 96), "conv2": (128 * 27 * 27, 256)}
CFG = {"alpha": 1e-4, "beta": 0.75, "k": 2.0, "n": 5}
COPIES = 3


def time_checkout(root: str, step: bool) -> None:
    """Prints three mean times, in ms, of each kernel at each shape (and
    of the AlexNet step) of the checkout at ``root``: this process
    imports that checkout's package."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    for name, (rows, c) in SHAPES.items():
        copies = [((30.0 * torch.randn(rows, c, generator=gen, device="cuda"))
                   .to(torch.bfloat16),
                   torch.randn(rows, c, generator=gen, device="cuda")
                   .to(torch.bfloat16)) for _ in range(COPIES)]
        calls = {"lrn_forward": lambda x, e: fk.lrn_forward(x, **CFG),
                 "lrn_backward": lambda x, e: fk.lrn_backward(x, e, **CFG),
                 # PyTorch's elementwise kernels on the same bytes: what
                 # streaming them costs on this card without the LRN
                 "clone (B1's bytes)": lambda x, e: x.clone(),
                 "add (B2's bytes)": lambda x, e: x + e}
        for kernel, fn in calls.items():
            fn = smoke.rotating(fn, copies)
            times = [smoke.graph_ms(fn, 7 * COPIES, 1) for _ in range(3)]
            print(f"{kernel} {name} {(rows, c)} bfloat16 from {root}: "
                  + " ".join(f"{ms:.4f}" for ms in times) + " ms",
                  flush=True)
        del copies
    if not step:
        return
    wf = smoke.make_alexnet(smoke.ALEX_BATCH, 12 * smoke.ALEX_BATCH)
    times = [smoke.timed_steps(wf, 2 if i == 0 else 0, 10) for i in range(3)]
    print(f"alexnet step (B={smoke.ALEX_BATCH}, bfloat16) from {root}: "
          + " ".join(f"{ms:.3f}" for ms in times) + " ms", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="+", help="checkout roots, in turn")
    parser.add_argument("--step", action="store_true",
                        help="also time the full-width AlexNet train step")
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)  # time one root, here
    args = parser.parse_args()
    if args.one:
        time_checkout(args.roots[0], args.step)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one", root]
                       + (["--step"] if args.step else []), check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
