#!/usr/bin/env python3
"""Time the native decode pool against PIL on the same image files.

The pool (``znicz_tpu_torch.native.ImagePipeline``: the package's own
JPEG and PNG decoders, bilinear resize, crop) decodes the files in
minibatches of 128 into a uint8 NHWC buffer, resized to ``--resize``
and center-cropped to ``--crop``, as the ``imagenet`` sample's loader
asks of it; PIL does the same work one file at a time in one thread
(``Image.open(...).convert("RGB")``, a bilinear resize, the crop), its
bundled libjpeg-turbo and its SIMD routes the library's yardstick.  The
pool decodes every file; PIL, whose single-threaded rate needs no long
run, every ``--pil-every``-th (a stride coprime with a repeating mix of
kinds keeps the mix).  For each pool thread count the two run in
turns, pool, PIL, PIL, pool, after one untimed pass that warms the page
cache.  The pool's library
is built first, so no run pays for the build.  Prints one line a
thread count, images/s of each run, then the host's CPU count::

    python3 tools/decode_ab.py <directory of images> --threads 1 4 0
    python3 tools/decode_ab.py a.jpg b.png ... --limit 256 --pil-every 3

``--threads 0`` is the pool's default, the host's hardware concurrency.
``chip_smoke.py`` phase 17 (b) calls :func:`ab` on the tree it writes.
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTENSIONS = (".jpg", ".jpeg", ".png")
BATCH = 128


def list_images(args: list[str]) -> list[str]:
    """The image files named, and those under the directories named, in
    sorted order."""
    paths = []
    for arg in args:
        if os.path.isdir(arg):
            for base, _dirs, files in sorted(os.walk(arg)):
                paths += [os.path.join(base, f) for f in sorted(files)
                          if f.lower().endswith(EXTENSIONS)]
        else:
            paths.append(arg)
    return paths


def pool_run(pipe, paths: list[str], resize: int, crop: int) -> float:
    """Seconds for the pool to decode ``paths``, a minibatch at a time;
    raises if a file failed."""
    out = np.empty((BATCH, crop, crop, 3), np.uint8)
    t0 = time.perf_counter()
    for i in range(0, len(paths), BATCH):
        chunk = paths[i:i + BATCH]
        pipe.submit(chunk, out[:len(chunk)], out_hw=(crop, crop),
                    resize_hw=(resize, resize))
        failed = pipe.wait()
        if failed:
            raise RuntimeError(f"{failed} files failed to decode")
    return time.perf_counter() - t0


def pil_run(paths: list[str], resize: int, crop: int) -> float:
    """Seconds for PIL, one file at a time, to do the pool's work."""
    from PIL import Image
    off = (resize - crop) // 2
    t0 = time.perf_counter()
    for path in paths:
        with Image.open(path) as img:
            img = img.convert("RGB").resize((resize, resize),
                                            Image.BILINEAR)
            np.asarray(img)[off:off + crop, off:off + crop].copy()
    return time.perf_counter() - t0


def ab(paths: list[str], threads=(1, 4, 0), resize: int = 256,
       crop: int = 227, pil_every: int = 1) -> dict:
    """``{threads: {"pool": [img/s, img/s], "pil": [img/s, img/s]}}``,
    each thread count's runs in turns: pool, PIL, PIL, pool; the pool
    over ``paths``, PIL over ``paths[::pil_every]``."""
    sys.path.insert(0, HERE)
    from znicz_tpu_torch.native import ImagePipeline
    if not ImagePipeline.available():
        raise RuntimeError(ImagePipeline.build_error())
    pil_paths = paths[::pil_every]
    warm = ImagePipeline(0)
    try:
        pool_run(warm, paths, resize, crop)  # the page cache
    finally:
        warm.close()
    rates = {}
    for t in threads:
        pipe = ImagePipeline(t)
        try:
            runs = {"pool": [], "pil": []}
            for kind in ("pool", "pil", "pil", "pool"):
                if kind == "pool":
                    runs[kind].append(len(paths) / pool_run(
                        pipe, paths, resize, crop))
                else:
                    runs[kind].append(len(pil_paths) / pil_run(
                        pil_paths, resize, crop))
        finally:
            pipe.close()
        rates[t] = runs
    return rates


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("images", nargs="+",
                        help="image files or directories of them")
    parser.add_argument("--threads", type=int, nargs="+", default=[1, 4, 0],
                        help="pool thread counts (0: the host's cores)")
    parser.add_argument("--resize", type=int, default=256)
    parser.add_argument("--crop", type=int, default=227)
    parser.add_argument("--limit", type=int, default=0,
                        help="time the first LIMIT files only")
    parser.add_argument("--pil-every", type=int, default=1,
                        help="PIL decodes every N-th file only")
    args = parser.parse_args(argv)
    paths = list_images(args.images)
    if args.limit:
        paths = paths[:args.limit]
    if not paths:
        parser.error("no image files")
    rates = ab(paths, args.threads, args.resize, args.crop, args.pil_every)
    n_pil = len(paths[::args.pil_every])
    for t, runs in rates.items():
        label = f"{t} threads" if t else f"default ({os.cpu_count()}) threads"
        print(f"{len(paths)} files, resize {args.resize}, crop {args.crop}, "
              f"pool {label}: pool "
              + " / ".join(f"{r:.1f}" for r in runs["pool"])
              + f" img/s; PIL (1 thread, {n_pil} files) "
              + " / ".join(f"{r:.1f}" for r in runs["pil"]) + " img/s")
    print(f"host CPUs: {os.cpu_count()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
