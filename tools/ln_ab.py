#!/usr/bin/env python3
"""Time the layer-norm kernels (B5, B6) of several checkouts on one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given:
``layer_norm_forward`` and ``layer_norm_backward`` (β on, ε = 1e-5) at
the sequence stack's training shape (16·2048, 512) in bf16 and in f32,
and the forward at serving's bucket of one sequence (2048, 512) in
bf16, as ``chip_smoke.py`` phase 2 times them.  Each (kernel, shape) is
timed as three runs, each of 21 calls captured in a CUDA graph and
replayed between CUDA events (near 0.03 ms the wrapper's enqueue nears
the kernel's time, so calls launched one by one may time the host); the
calls rotate over three copies of their inputs, since a 32 MB bf16 x
would otherwise stay in the 50 MB L2.  Beside the kernels, each process
times, in the same way on the same inputs, the library calls that
compute the same functions (``F.layer_norm``, ``aten.native_layer_norm_
backward``) and PyTorch's ``clone`` and ``add``, which move B5's and
B6's bytes (read one array and write one; read two and write one): a
yardstick of what streaming those bytes costs on the card.  The graphs
and the rotation come from this checkout's ``chip_smoke.py``.  Give the
checkouts in turns to see the spread on one card, e.g. with the parent
unpacked into ``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/ln_ab.py build/parent . . build/parent

Prints one line a checkout and (kernel, shape), then the card's name and
power limit.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name → rows, D, dtype, whether the backward is timed at it
SHAPES = {"training": (16 * 2048, 512, "bfloat16", True),
          "training_f32": (16 * 2048, 512, "float32", True),
          "bucket1": (2048, 512, "bfloat16", False)}
EPS = 1e-5
COPIES = 3
#: the backward's kernels, whose device times a call are printed apart
BWD_KERNELS = ("ln_bwd_reg_kernel", "ln_bwd_reg_fold_kernel",
               "ln_bwd_rows_kernel", "ln_bwd_fold_kernel")


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
    aten = torch.ops.aten
    for name, (rows, d, dtype_name, backward) in SHAPES.items():
        dtype = getattr(torch, dtype_name)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
        g_t, b_t = gamma.to(dtype), beta.to(dtype)
        copies = []
        for _ in range(COPIES):
            x = (2.0 * torch.randn(rows, d, generator=gen, device="cuda")
                 + 0.5).to(dtype)
            e = (0.1 * torch.randn(rows, d, generator=gen,
                                   device="cuda")).to(dtype)
            _, mean, rstd = aten.native_layer_norm(x, (d,), g_t, b_t, EPS)
            copies.append((x, e, mean, rstd))
        calls = {
            "layer_norm_forward": lambda x, e, mu, r: fk.layer_norm_forward(
                x, gamma, beta, EPS),
            "F.layer_norm": lambda x, e, mu, r: F.layer_norm(
                x, (d,), g_t, b_t, EPS),
            # PyTorch's elementwise kernels on the same bytes: what
            # streaming them costs on this card without the layer norm
            "clone (B5's bytes)": lambda x, e, mu, r: x.clone()}
        if backward:
            calls.update({
                "layer_norm_backward":
                    lambda x, e, mu, r: fk.layer_norm_backward(
                        x, e, gamma, EPS, True),
                "native_layer_norm_backward":
                    lambda x, e, mu, r: aten.native_layer_norm_backward(
                        e, x, (d,), mu, r, g_t, b_t, [True, True, True]),
                "add (B6's bytes)": lambda x, e, mu, r: x + e})
        for kernel, fn in calls.items():
            fn = smoke.rotating(fn, copies)
            times = [smoke.graph_ms(fn, 7 * COPIES, 1) for _ in range(3)]
            print(f"{kernel} {name} {(rows, d)} {dtype_name} from {root}: "
                  + " ".join(f"{ms:.5f}" for ms in times) + " ms",
                  flush=True)
            if kernel == "layer_norm_backward":
                split = smoke.kernel_split_ms(fn, 7 * COPIES, BWD_KERNELS)
                print("  its launches by a profiler window: " + ", ".join(
                    f"{k} {ms:.5f} ms" for k, ms in split.items() if ms),
                    flush=True)
        del copies


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
