#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (znicz_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit::

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. prints the card's name and power limit (``nvidia-smi``), then builds
   every kernel from ``znicz_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a`` and prints the compiler's register/shared-memory lines;
2. kernels: holds each kernel against its plain PyTorch version on the
   card, at the serving shapes and at the edge cases, within the
   tolerance printed beside each case; times the kernel, the plain
   version and one PyTorch library call for the same function (a
   yardstick only — the port never calls it) and computes the bound
   (the least time the card could take: bytes over 3.35 TB/s or
   operations over the peak rate for their type, the larger);
3. slice: writes a full-width bf16 scorer bundle in the reference
   format (attention 8 heads → layer_norm → softmax over 8 classes,
   T=2048, D=512, weights from a fixed seed), serves ragged requests of
   1, 3 and 16 rows through ``ServingEngine(max_batch=16)`` with every
   kernel's launch counter set to 0 just before and read just after,
   checks that each counter rose on every dispatch, and holds the
   1-row reply against ``ExportedModel.load(path, device="cpu")``.

The last two lines of standard output are one JSON object listing the
kernels with their numbers, then ``{"ok": true, "device": ...}``.
Without a CUDA device, or without ``nvcc``, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12

SEED = 20261016
#: the full-width scorer (benchmarks/seq_bench.py's sequence stack)
BATCH, SEQ, DIM, HEADS, CLASSES = 16, 2048, 512, 8, 8
#: 1-row GPU reply vs the CPU reply of the same bundle, probabilities:
#: both round at the same points (the request, q/k/v, p, the attention
#: and layer-norm outputs) but sum in other orders, which moves some
#: bf16 activations by one rounding step; over the 2048·512 inputs of
#: the head those steps add up to a few 1e-3 of a logit, a few 1e-4 of
#: a probability.  The bound leaves a margin of ten.
SLICE_TOL = 1e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
#: name, B, Tq, Tk, H, dh, causal, q_offset, k_offset
ATTN_CASES = (
    ("serving", BATCH, SEQ, SEQ, HEADS, DIM // HEADS, False, 0, 0),
    ("causal", BATCH, SEQ, SEQ, HEADS, DIM // HEADS, True, 0, 0),
    ("dh128", 4, SEQ, SEQ, 4, 128, False, 0, 0),
    ("dh128_causal", 4, SEQ, SEQ, 4, 128, True, 0, 0),
    # keys placed after the first 512 queries: those rows are fully
    # masked (out 0, lse -1e30)
    ("offsets", 2, 1024, 1024, HEADS, 64, True, 512, 1024),
    ("ragged", 3, 1000, 1000, HEADS, 64, False, 0, 0),
    ("ragged_cross", 2, 1000, 777, 4, 128, True, 300, 0),
)
#: bf16 operands: out differs by bf16 rounding of p at different
#: running maxima and by summation order; lse is f32 throughout
ATTN_OUT_TOL, ATTN_LSE_TOL = 2e-2, 1e-3


def _visible_pairs(tq: int, tk: int, causal: bool, q_off: int,
                   k_off: int) -> int:
    if not causal:
        return tq * tk
    return sum(min(max(q_off + i - k_off + 1, 0), tk) for i in range(tq))


def check_flash(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import flash_attention as fa
    row = None
    for name, b, tq, tk, h, dh, causal, q_off, k_off in ATTN_CASES:
        d = h * dh
        # q/k/v as strided slices of packed projections, as the
        # attention unit hands them over
        qkv_q = torch.randn(b, tq, 3 * d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        qkv_k = torch.randn(b, tk, 3 * d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        q = qkv_q[..., :d].view(b, tq, h, dh)
        k = qkv_k[..., d:2 * d].view(b, tk, h, dh)
        v = qkv_k[..., 2 * d:].view(b, tk, h, dh)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, q_off, k_off)
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal, q_off,
                                                    k_off)
        torch.cuda.synchronize()
        err_o, err_l = max_err(out, ref_out), max_err(lse, ref_lse)
        finite = bool(torch.isfinite(out.float()).all()
                      and torch.isfinite(lse).all())
        say(f"  flash_attention_fwd {name}: B={b} Tq={tq} Tk={tk} H={h} "
            f"dh={dh} causal={causal} offsets=({q_off},{k_off}) "
            f"max_abs_err out={err_o:.3g} (tol {ATTN_OUT_TOL}) "
            f"lse={err_l:.3g} (tol {ATTN_LSE_TOL})")
        if not finite or err_o > ATTN_OUT_TOL or err_l > ATTN_LSE_TOL:
            raise AssertionError(f"flash_attention_fwd disagrees with its "
                                 f"plain version in case '{name}'")
        if name != "serving":
            continue
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal), 20)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                           5, warmup=1)
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), 20)
        flops = 4.0 * b * h * dh * _visible_pairs(tq, tk, causal, q_off,
                                                  k_off)
        nbytes = 2.0 * (2 * b * tq * d + 2 * b * tk * d) + 4.0 * b * h * tq
        bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
        say(f"  flash_attention_fwd {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops:.4g} FLOP, {nbytes:.4g} B)")
        row = {"name": "flash_attention_fwd", "route": "cuda",
               "source": "znicz_tpu_torch/csrc/flash_attention_fwd.cu",
               "replaces": "znicz_tpu/ops/pallas_attention.py:173",
               "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
    return row


#: name, rows, D, dtype, with beta
LN_CASES = (
    ("serving", BATCH * SEQ, DIM, "bfloat16", True),
    ("no_beta", BATCH * SEQ, DIM, "bfloat16", False),
    ("f32", BATCH * SEQ, DIM, "float32", True),
    ("f32_no_beta", BATCH * SEQ, DIM, "float32", False),
    ("ragged_width", 1000, 100, "bfloat16", True),
)


def _ln_tol(dtype, ref) -> float:
    """bf16 output: one bf16 ulp of the largest |y| (a rounding flip
    from f32 statistics summed in another order); f32: 1e-5 (rsqrtf
    and summation order)."""
    import torch
    if dtype == torch.bfloat16:
        return 2.0 ** -7 * float(ref.float().abs().max())
    return 1e-5


def check_layer_norm(gen) -> dict:
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import fused_kernels as fk
    row = None
    eps = 1e-5
    for name, m, d, dtype_name, with_beta in LN_CASES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(m, d, generator=gen, device="cuda") * 2.0
             + 0.5).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = (0.1 * torch.randn(d, generator=gen, device="cuda")
                if with_beta else None)
        y = fk.layer_norm_forward(x, gamma, beta, eps)
        ref = fk.layer_norm_forward_plain(x, gamma, beta, eps)
        torch.cuda.synchronize()
        err, tol = max_err(y, ref), _ln_tol(dtype, ref)
        say(f"  layer_norm_forward {name}: ({m}, {d}) {dtype_name} "
            f"beta={with_beta} max_abs_err={err:.3g} (tol {tol:.3g})")
        if y.dtype != x.dtype or not bool(torch.isfinite(y.float()).all()) \
                or err > tol:
            raise AssertionError(f"layer_norm_forward disagrees with its "
                                 f"plain version in case '{name}'")
        if name != "serving":
            continue
        ms = time_ms(lambda: fk.layer_norm_forward(x, gamma, beta, eps), 50)
        plain_ms = time_ms(
            lambda: fk.layer_norm_forward_plain(x, gamma, beta, eps), 20)
        g16, b16 = gamma.to(dtype), beta.to(dtype)
        lib_ms = time_ms(lambda: F.layer_norm(x, (d,), g16, b16, eps), 50)
        elem = m * d
        nbytes = 2.0 * elem * x.element_size() + 4.0 * d * 2
        bound_ms, bound_by = bound(nbytes, 8.0 * elem, PEAK_F32_FLOP_S)
        say(f"  layer_norm_forward {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes:.4g} B)")
        row = {"name": "layer_norm_forward", "route": "cuda",
               "source": "znicz_tpu_torch/csrc/layer_norm_fwd.cu",
               "replaces": "znicz_tpu/ops/pallas_kernels.py:182",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
    return row


# ----------------------------------------------------------------------
# phase 3: the serving slice at full width
# ----------------------------------------------------------------------
def write_scorer_bundle(path: str) -> None:
    """A bf16 attention → layer_norm → softmax scorer bundle in the
    reference's export format, weights from ``SEED``."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    t, d, c = SEQ, DIM, CLASSES

    def normal(shape, std):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    params = {
        "layer0_weights": normal((d, 3 * d), d ** -0.5),
        "layer0_bias": normal((3 * d,), 0.1),
        "layer0_weights_out": normal((d, d), d ** -0.5),
        "layer0_bias_out": normal((d,), 0.1),
        "layer1_weights": 1.0 + normal((d,), 0.1),
        "layer1_bias": normal((d,), 0.1),
        "layer2_weights": normal((t * d, c), (t * d) ** -0.5),
        "layer2_bias": normal((c,), 0.1),
    }
    layers = [("attention", {"n_heads": HEADS, "causal": False}),
              ("layer_norm", {"eps": 1e-5}),
              ("softmax", {"output_sample_shape": c})]
    manifest = {
        "format": "znicz-tpu-forward", "version": 1,
        "workflow": "chip_smoke_scorer", "loss": "softmax",
        "input_shape": [t, d], "dtype": "bfloat16", "kind": "scorer",
        "layers": [{"type": kind, "config": cfg, "has_weights": True,
                    "has_bias": True, "name": f"{kind}{i}"}
                   for i, (kind, cfg) in enumerate(layers)],
    }
    np.savez(path, manifest=np.frombuffer(json.dumps(manifest).encode(),
                                          dtype=np.uint8), **params)


def unit_breakdown(model, x) -> None:
    """Device time of each unit of the chain at the full bucket."""
    import torch
    with torch.inference_mode():
        h = torch.from_numpy(x).to(model.dtype).to(model.device)
        parts = []
        for unit in model.forwards:
            parts.append(f"{type(unit).__name__} "
                         f"{time_ms(lambda: unit(h), 5):.4f} ms")
            h = unit(h)
    say(f"  per-unit device time at batch {x.shape[0]}: "
        + ", ".join(parts))


def serve_slice(path: str, kernels) -> dict:
    import numpy as np
    import torch
    from znicz_tpu_torch.export import ExportedModel
    from znicz_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(SEED + 1)
    x = rng.normal(0.0, 0.3, size=(BATCH, SEQ, DIM)).astype(np.float32)

    def counts():
        return [k.launches for k in kernels]

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    eng = ServingEngine(path, max_batch=BATCH, max_delay_ms=2.0)
    try:
        eng.start()
        say(f"  engine started in {time.perf_counter() - t0:.2f} s "
            f"(buckets {eng.stats()['buckets_warmed']}, warmup "
            f"{eng.warmup_seconds:.2f} s)")
        replies = {}
        for n in (1, 3, 16):
            before = counts()
            y = eng(x[:n], timeout=300)
            rose = [a - b for a, b in zip(counts(), before)]
            say(f"  request of {n} rows → reply {y.shape}, launches "
                f"{dict(zip((k.__name__ for k in kernels), rose))}")
            if any(r < 1 for r in rose):
                raise AssertionError(f"a kernel did not launch on the "
                                     f"{n}-row dispatch: {rose}")
            if y.shape != (n, CLASSES) or not np.isfinite(y).all() \
                    or np.abs(y.sum(axis=1) - 1.0).max() > 1e-4:
                raise AssertionError(f"bad {n}-row reply: {y}")
            replies[n] = y
        lat, rows = [], 0
        t_loop = time.perf_counter()
        for i in range(30):
            n = (1, 3, 16)[i % 3]
            t_req = time.perf_counter()
            eng(x[:n], timeout=300)
            lat.append(time.perf_counter() - t_req)
            rows += n
        wall = time.perf_counter() - t_loop
        launches = counts()
        lat.sort()
        say(f"  served 30 sequential requests (1/3/16 rows): p50 latency "
            f"{1e3 * lat[len(lat) // 2]:.3f} ms, {rows / wall:.1f} rows/s, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        unit_breakdown(eng.model, x)
    finally:
        eng.shutdown()

    cpu = ExportedModel.load(path, device="cpu")
    ref = cpu(x[:1])
    err = float(np.abs(ref - replies[1]).max())
    same = bool((ref.argmax(1) == replies[1].argmax(1)).all())
    say(f"  1-row reply vs ExportedModel(device='cpu'): max_abs_err "
        f"{err:.3g} (tol {SLICE_TOL}), argmax agree={same}")
    if err > SLICE_TOL or not same:
        raise AssertionError("the card's reply disagrees with the CPU's")
    return dict(zip((k.__name__ for k in kernels), launches))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing to check",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "znicz_tpu_torch", "csrc")):
        print(f"chip_smoke: no znicz_tpu_torch/csrc beside {__file__} — "
              f"run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from znicz_tpu_torch.ops import _cuda
    from znicz_tpu_torch.ops import flash_attention as fa
    from znicz_tpu_torch.ops import fused_kernels as fk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    say("phase 1: build")
    t0 = time.perf_counter()
    _cuda.build_all()
    say(f"  built in {time.perf_counter() - t0:.1f} s into "
        f"{os.path.relpath(_cuda.build_dir(), REPO)}")
    for name in _cuda.SOURCES:
        stem = os.path.splitext(name)[0]
        for line in _cuda.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {stem}: {line.strip()}")

    say("phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {"flash_attention_fwd": check_flash(gen),
            "layer_norm_forward": check_layer_norm(gen)}

    say("phase 3: full-width bf16 scorer through ServingEngine")
    kernels = (fa.flash_attention_fwd, fk.layer_norm_forward)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scorer.npz")
        write_scorer_bundle(path)
        launches = serve_slice(path, kernels)
    for name, row in rows.items():
        row["launches"] = launches[name]

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
