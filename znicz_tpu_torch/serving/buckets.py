"""Bucket-ladder math for the serving engine (copy of
``znicz_tpu/serving/buckets.py``).

A ragged request stream (64, 64, 37, 1, 64, …) served through an
exact-batch-size program cache pays a fresh trace+compile for every
distinct size and keeps every program forever.  Rounding sizes up to a
power-of-two ladder caps the number of live programs at
``log2(max_batch) + 1`` while wasting at most 2× compute on the padded
tail (amortized far less on real traffic, where the batcher coalesces
toward full buckets).

``align`` folds data-parallel replication in: a batch sharded over an
``n_data``-way mesh axis must divide evenly (jax shardings reject
ragged splits), so the ladder becomes ``align·1, align·2, align·4, …``
— every bucket a legal data-axis split, ladder length
``log2(max_batch / align) + 1 ≤ log2(max_batch) + 1``.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (n ≥ 1)."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def bucket_for(n: int, align: int = 1) -> int:
    """The ladder bucket covering a batch of ``n`` rows: the smallest
    ``align * 2**k ≥ n``.  With ``align=1`` this is the classic
    power-of-two ladder; with ``align = n_data`` every bucket divides
    evenly over the mesh's data axis."""
    if align < 1:
        raise ValueError(f"need align >= 1, got {align}")
    return align * next_pow2(max(1, -(-n // align)))


def ladder(max_batch: int, align: int = 1) -> list[int]:
    """All buckets up to (and covering) ``max_batch``:
    ``[align, 2·align, 4·align, …, bucket_for(max_batch)]``.  This is
    the warmup set — compiling exactly these programs at engine start
    means zero compiles at serve time for any request ≤ ``max_batch``.
    """
    if max_batch < 1:
        raise ValueError(f"need max_batch >= 1, got {max_batch}")
    out = []
    b = align
    top = bucket_for(max_batch, align)
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return out
