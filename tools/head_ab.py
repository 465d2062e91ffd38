#!/usr/bin/env python3
"""Time the softmax + argmax (B4) and dropout (B3) kernels of several
checkouts on one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given:
``softmax_argmax`` on f32 logits at the AlexNet head's (128, 1000) and
at the serving buckets' and the sequence stack's (16, 8), and
``dropout_apply`` (ratio 0.5) at AlexNet's fc activations (128, 4096)
in bf16 and in f32, as ``chip_smoke.py`` phase 2 times them.  Each
(kernel, shape) is timed as three runs, each of 50 calls captured in a
CUDA graph and replayed between CUDA events: the kernels take less time
than their wrappers' enqueue, so calls launched one by one would time
the host.  Beside the kernels, each process times, in the same way on
the same inputs, the library calls that compute the same functions
(``torch.softmax``; ``F.dropout``, whose mask is another one) and, where
the checkout has it, one launch of an empty kernel: the floor under any
kernel node of such a graph.  The graphs come from this checkout's
``chip_smoke.py``.  Give the checkouts in turns to see the spread on one
card, e.g. with the parent unpacked into ``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/head_ab.py build/parent . . build/parent

Prints one line a checkout and (kernel, shape), then the card's name and
power limit.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: B4's shapes: name → (rows, classes)
SOFTMAX_SHAPES = {"head": (128, 1000), "small": (16, 8)}
#: B3's shapes: name → ((rows, features), dtype)
DROPOUT_SHAPES = {"fc": ((128, 4096), "bfloat16"),
                  "fc_f32": ((128, 4096), "float32")}
SEED = 20261016


def time_checkout(root: str) -> None:
    """Prints three mean times, in ms, of each kernel (and yardstick) at
    each shape, with the kernels of the checkout at ``root``: this
    process imports that checkout's package."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import fused_kernels as fk
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def report(kernel, name, shape, dtype, fn):
        times = [smoke.graph_ms(fn) for _ in range(3)]
        print(f"{kernel} {name} {shape} {dtype} from {root}: "
              + " ".join(f"{ms:.5f}" for ms in times) + " ms", flush=True)

    for name, (rows, c) in SOFTMAX_SHAPES.items():
        v = 3.0 * torch.randn(rows, c, generator=gen, device="cuda")
        report("softmax_argmax", name, (rows, c), "float32",
               lambda: fk.softmax_argmax(v))
        report("torch.softmax", name, (rows, c), "float32",
               lambda: torch.softmax(v, dim=1))
    # a checkout whose kernel reads its seed from device memory gets it
    # as a device tensor, as its training path passes it (an int would
    # add a fill kernel to every call)
    seed = (fk.seed_tensor(SEED, "cuda") if hasattr(fk, "seed_tensor")
            else SEED)
    for name, (shape, dtype_name) in DROPOUT_SHAPES.items():
        x = torch.randn(*shape, generator=gen, device="cuda").to(
            getattr(torch, dtype_name))
        report("dropout_apply", name, shape, dtype_name,
               lambda: fk.dropout_apply(x, seed, 0.5))
        report("F.dropout", name, shape, dtype_name,
               lambda: F.dropout(x, 0.5, training=True))
    lib = fk._lib("dropout")
    if hasattr(lib, "znicz_empty_launch"):
        empty = lib.znicz_empty_launch
        empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
        report("empty kernel", "launch", (1, 32), "-",
               lambda: empty(torch.cuda.current_stream().cuda_stream))


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
