#!/usr/bin/env python3
"""Time the flash-attention forward (B7) of several checkouts on one card.

Each argument is the root of a checkout of this repository; each is
timed in a process of its own, in the order given, at the serving shape
(bf16 q/k/v of shape (16, 2048, 8, 64) as strided views of one packed
projection, non-causal): three runs of 20 back-to-back calls between
CUDA events, after 3 warm-up calls.  Give the checkouts in turns to see
the spread on one card, e.g. with the parent unpacked into ``build/``::

    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/flash_fwd_ab.py build/parent . . build/parent

Prints one line a checkout, then the card's name and power limit.
"""

import os
import subprocess
import sys

SHAPE = (16, 2048, 8, 64)  # B, T, H, dh of the scorer chip_smoke.py serves


def time_checkout(root: str) -> list[float]:
    """Three mean times, in ms, of the forward of the checkout at
    ``root``: this process imports that checkout's package."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from znicz_tpu_torch.ops import flash_attention as fa
    b, t, h, dh = SHAPE
    d = h * dh
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    qkv = torch.randn(b, t, 3 * d, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].view(b, t, h, dh)
               for i in range(3))
    for _ in range(3):
        fa.flash_attention_fwd(q, k, v)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fa.flash_attention_fwd(q, k, v)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return times


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        times = time_checkout(sys.argv[2])
        print(f"B7 {SHAPE} bf16 from {sys.argv[2]}: "
              + " ".join(f"{ms:.4f}" for ms in times) + " ms", flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
