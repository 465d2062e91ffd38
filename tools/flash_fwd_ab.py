#!/usr/bin/env python3
"""Time the flash-attention kernels of several checkouts on one card.

Each positional argument is the root of a checkout of this repository;
each is timed in a process of its own, in the order given.  By default
the forward (B7) at the serving shape: bf16 q/k/v of shape
(16, 2048, 8, 64) as strided views of one packed projection,
non-causal.  ``--kernel`` picks the kernels (``fwd``, ``dq`` for B8,
``dkv`` for B9, or ``all``) and ``--dh`` the head dims, each at
D = 512 (8 heads of 64, 2 of 256, 16 of 32) with B = 16 and T = 2048;
an f32 head dim of 512 runs at B = 2, T = 1024 (one head), as
``chip_smoke.py`` times it.  ``--dtype float32`` times the f32 kernels
on f32 operands (the bf16 kernels by default).  Every (kernel, head
dim) is timed as three runs of 20 back-to-back calls between CUDA
events, after 3 warm-up calls.  Give the checkouts
in turns to see the spread on one card, e.g. with the parent unpacked
into ``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/flash_fwd_ab.py build/parent . . build/parent
    python3 tools/flash_fwd_ab.py --kernel all --dh 64,256,32 \\
        build/parent . . build/parent
    python3 tools/flash_fwd_ab.py --dtype float32 --kernel all \\
        --dh 64,256,32,512 build/parent . . build/parent

Prints one line a checkout and (kernel, head dim), then the card's name
and power limit.
"""

import argparse
import os
import subprocess
import sys

BATCH, SEQ, DIM = 16, 2048, 512  # the sequence stack chip_smoke.py runs
KERNELS = ("fwd", "dq", "dkv")


def time_checkout(root: str, kernels: list[str], dhs: list[int],
                  dtype_name: str) -> None:
    """Prints three mean times, in ms, of each kernel at each head dim
    of the checkout at ``root``: this process imports that checkout's
    package."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from znicz_tpu_torch.ops import flash_attention as fa
    dtype = getattr(torch, dtype_name)
    for dh in dhs:
        b, t, h = BATCH, SEQ, DIM // dh
        if dh >= DIM and dtype == torch.float32:
            b, t = 2, 1024
        d = h * dh
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        qkv = torch.randn(b, t, 3 * d, generator=gen, device="cuda",
                          dtype=dtype)
        q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, t, h, dh)
                   for i in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v)
        dout = torch.randn(out.shape, generator=gen, device="cuda",
                           dtype=dtype)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        calls = {"fwd": lambda: fa.flash_attention_fwd(q, k, v),
                 "dq": lambda: fa.flash_attention_dq(q, k, v, dout, lse,
                                                     delta),
                 "dkv": lambda: fa.flash_attention_dkv(q, k, v, dout, lse,
                                                       delta)}
        for name in kernels:
            fn = calls[name]
            for _ in range(3):
                fn()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / 20)
            print(f"{name} {(b, t, h, dh)} {dtype_name} from {root}: "
                  + " ".join(f"{ms:.4f}" for ms in times) + " ms",
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("roots", nargs="+", help="checkout roots, in turn")
    parser.add_argument("--kernel", choices=(*KERNELS, "all"),
                        default="fwd", help="fwd (B7, the default), dq "
                        "(B8), dkv (B9) or all")
    parser.add_argument("--dh", default="64",
                        help="comma-separated head dims (default 64)")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        default="bfloat16", help="operand dtype (default "
                        "bfloat16)")
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)  # time one root, here
    args = parser.parse_args()
    kernels = list(KERNELS) if args.kernel == "all" else [args.kernel]
    dhs = [int(x) for x in args.dh.split(",")]
    if args.one:
        time_checkout(args.roots[0], kernels, dhs, args.dtype)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, __file__, "--one", "--kernel",
                        args.kernel, "--dh", args.dh, "--dtype", args.dtype,
                        root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
