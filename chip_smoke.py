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
   1-row reply against ``ExportedModel.load(path, device="cpu")``;
4. training: builds the same stack (bf16, momentum SGD on every layer,
   as ``benchmarks/seq_bench.py`` trains it) through the port's
   ``StandardWorkflow`` on 4 × 16 samples made from a fixed seed,
   ``initialize()`` with no device (the card), sets every launch
   counter to 0, runs 2 warm-up and 10 timed train steps, checks that
   each of the five kernels launched once per step and that the loss is
   finite, prints the step time, tokens/s, MFU, the device time of each
   unit and the peak memory; then holds one train step on the card
   (B=2, full T and D) against the same step on the CPU.

The last two lines of standard output are one JSON object listing the
kernels with their numbers, then ``{"ok": true, "device": ...}``.
Without a CUDA device, or without ``nvcc``, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import re
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
#: one train step on the card against the same step on the CPU: each
#: parameter's update, relative to its largest |update|.  Both round at
#: the same points, but the kernels sum in other orders than the plain
#: versions, which flips single bf16 roundings of p, ds, δ and the
#: stored activations; each flip moves every gradient it feeds by one
#: bf16 step of that term (2⁻⁸ relative), and the CPU tests see ~1e-2
#: of the largest momentum after several steps for the same reason.
TRAIN_STEP_TOL = 5e-2


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


#: the case given a random nonzero lse cotangent (the ring's term)
DLSE_CASE = "ragged_cross"
#: dq, dk and dv against the plain version, relative to the largest
#: |reference|: both round p and ds to bf16 before their products, at
#: exp(s − lse) values that differ in the last f32 bits (expf and another
#: summation order of s), which flips single bf16 roundings of p and ds;
#: the f32 sums then round once more to bf16
ATTN_BWD_TOL = 1e-2


def _attn_bwd_flops(b, h, dh, tq, tk, causal, q_off, k_off, products):
    return 2.0 * products * b * h * dh * _visible_pairs(tq, tk, causal,
                                                        q_off, k_off)


def check_flash_bwd(gen) -> dict:
    """B8 and B9 against their plain versions in every geometry of
    ``ATTN_CASES``, then their times at the training shape."""
    import torch
    import torch.nn.functional as F
    from znicz_tpu_torch.ops import flash_attention as fa
    rows = {}
    for name, b, tq, tk, h, dh, causal, q_off, k_off in ATTN_CASES:
        d = h * dh
        qkv_q = torch.randn(b, tq, 3 * d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        qkv_k = torch.randn(b, tk, 3 * d, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        q = qkv_q[..., :d].view(b, tq, h, dh)
        k = qkv_k[..., d:2 * d].view(b, tk, h, dh)
        v = qkv_k[..., 2 * d:].view(b, tk, h, dh)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, q_off, k_off)
        dout = torch.randn(b, tq, h, dh, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        if name == DLSE_CASE:
            delta = delta - torch.randn(b, h, tq, generator=gen,
                                        device="cuda")
        delta = delta.contiguous()
        args = (q, k, v, dout, lse, delta, causal, q_off, k_off)
        dq = fa.flash_attention_dq(*args)
        dk, dv = fa.flash_attention_dkv(*args)
        ref_dq = fa.flash_attention_dq_plain(*args)
        ref_dk, ref_dv = fa.flash_attention_dkv_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for key, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                              ("dv", dv, ref_dv)):
            scale = float(ref.float().abs().max())
            err = max_err(got, ref)
            errs[key] = err
            if not bool(torch.isfinite(got.float()).all()) \
                    or err > ATTN_BWD_TOL * max(scale, 1e-30):
                raise AssertionError(
                    f"flash_attention {key} disagrees with its plain "
                    f"version in case '{name}': {err:.3g} > "
                    f"{ATTN_BWD_TOL} x {scale:.3g}")
        say(f"  flash_attention_dq/dkv {name}: dlse={name == DLSE_CASE} "
            + ", ".join(f"{key} max_abs_err={e:.3g}" for key, e in
                        errs.items())
            + f" (tol {ATTN_BWD_TOL} x max|ref|)")
        if name != "serving":
            continue
        ms_dq = time_ms(lambda: fa.flash_attention_dq(*args), 10)
        ms_dkv = time_ms(lambda: fa.flash_attention_dkv(*args), 10)
        plain_dq = time_ms(lambda: fa.flash_attention_dq_plain(*args), 3,
                           warmup=1)
        plain_dkv = time_ms(lambda: fa.flash_attention_dkv_plain(*args),
                            3, warmup=1)
        # yardstick: one backward of scaled_dot_product_attention, which
        # computes dq, dk and dv together (the port never calls it)
        qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_()
                      for a in (q, k, v))
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        g = dout.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            o, (qh, kh, vh), g, retain_graph=True), 10)
        stat_bytes = 2 * 4.0 * b * h * tq
        for key, products, ms, plain_ms, nbytes in (
                ("flash_attention_dq", 3, ms_dq, plain_dq,
                 2.0 * (2 * b * tq * d + 2 * b * tk * d) + stat_bytes),
                ("flash_attention_dkv", 4, ms_dkv, plain_dkv,
                 2.0 * (2 * b * tq * d + 4 * b * tk * d) + stat_bytes)):
            flops = _attn_bwd_flops(b, h, dh, tq, tk, causal, q_off, k_off,
                                    products)
            bound_ms, bound_by = bound(nbytes, flops, PEAK_BF16_FLOP_S)
            say(f"  {key} {name}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, scaled_dot_product_attention "
                f"backward {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}: {flops:.4g} FLOP, {nbytes:.4g} B)")
            err = errs["dq"] if key.endswith("dq") else max(errs["dk"],
                                                            errs["dv"])
            rows[key] = {
                "name": key, "route": "cuda",
                "source": "znicz_tpu_torch/csrc/flash_attention_bwd.cu",
                "replaces": ("znicz_tpu/ops/pallas_attention.py:286"
                             if key.endswith("dq") else
                             "znicz_tpu/ops/pallas_attention.py:323"),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
    return rows


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


#: name, rows, D, dtype, with beta; 32771 rows fit no block tiling
LN_BWD_CASES = (
    ("training", BATCH * SEQ, DIM, "bfloat16", True),
    ("no_beta", BATCH * SEQ, DIM, "bfloat16", False),
    ("f32", BATCH * SEQ, DIM, "float32", True),
    ("ragged_width", 1000, 100, "bfloat16", True),
    ("ragged_rows", 32771, DIM, "bfloat16", True),
)
#: the f32 γ/β sums against the plain version, per column, relative to
#: the sum of the absolute terms: both add f32 terms, in other orders
LN_SUM_TOL = 1e-5


def check_layer_norm_bwd(gen) -> dict:
    import torch
    from znicz_tpu_torch.ops import fused_kernels as fk
    row = None
    eps = 1e-5
    for name, m, d, dtype_name, with_beta in LN_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(m, d, generator=gen, device="cuda") * 2.0
             + 0.5).to(dtype)
        err = (0.1 * torch.randn(m, d, generator=gen,
                                 device="cuda")).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        dx, gg, gb = fk.layer_norm_backward(x, err, gamma, eps, with_beta)
        rdx, rgg, rgb = fk.layer_norm_backward_plain(x, err, gamma, eps,
                                                     with_beta)
        again = fk.layer_norm_backward(x, err, gamma, eps, with_beta)
        torch.cuda.synchronize()
        xf = x.float()
        xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
            xf.var(-1, unbiased=False, keepdim=True) + eps)
        abs_g = (err.float() * xhat).abs().sum(0)
        abs_b = err.float().abs().sum(0)
        dx_tol = _ln_tol(dtype, rdx)
        err_dx = max_err(dx, rdx)
        rel_g = float(((gg - rgg).abs() / abs_g.clamp_min(1e-30)).max())
        rel_b = (float(((gb - rgb).abs() / abs_b.clamp_min(1e-30)).max())
                 if with_beta else 0.0)
        same_bits = all(torch.equal(a, b) for a, b in
                        zip((dx, gg, gb), again) if a is not None)
        say(f"  layer_norm_backward {name}: ({m}, {d}) {dtype_name} "
            f"beta={with_beta} dx max_abs_err={err_dx:.3g} (tol "
            f"{dx_tol:.3g}), sums max rel_err gamma={rel_g:.3g} "
            f"beta={rel_b:.3g} (tol {LN_SUM_TOL} of sum |terms|), rerun "
            f"bitwise={same_bits}")
        if dx.dtype != err.dtype or err_dx > dx_tol \
                or rel_g > LN_SUM_TOL or rel_b > LN_SUM_TOL \
                or (gb is None) == with_beta or not same_bits \
                or not bool(torch.isfinite(dx.float()).all()):
            raise AssertionError(f"layer_norm_backward disagrees with its "
                                 f"plain version in case '{name}'")
        if name != "training":
            continue
        args = (x, err, gamma, eps, with_beta)
        ms = time_ms(lambda: fk.layer_norm_backward(*args), 50)
        plain_ms = time_ms(lambda: fk.layer_norm_backward_plain(*args), 20)
        g16, b16 = gamma.to(dtype), torch.zeros_like(gamma).to(dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, (d,), g16, b16,
                                                         eps)
        lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            err, x, (d,), mean, rstd, g16, b16, [True, True, True]), 50)
        elem = m * d
        nbytes = 3.0 * elem * x.element_size() + 4.0 * d * 3
        bound_ms, bound_by = bound(nbytes, 20.0 * elem, PEAK_F32_FLOP_S)
        say(f"  layer_norm_backward {name}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, native_layer_norm_backward {lib_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes:.4g} B)")
        row = {"name": "layer_norm_backward", "route": "cuda",
               "source": "znicz_tpu_torch/csrc/layer_norm_bwd.cu",
               "replaces": "znicz_tpu/ops/pallas_kernels.py:191",
               "max_abs_err": err_dx, "ms": ms, "plain_ms": plain_ms,
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


# ----------------------------------------------------------------------
# phase 4: the training slice at full width
# ----------------------------------------------------------------------
def make_trainer(x, y, batch: int, device=None):
    """The seq_bench stack through the port's ``StandardWorkflow``:
    attention (8 heads) → layer_norm → softmax, momentum SGD on every
    layer, train samples only, bf16."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = "bfloat16"
    prng.seed_all(SEED)
    gd = {"learning_rate": 0.01, "gradient_moment": 0.9}
    wf = StandardWorkflow(
        name="chip_smoke_trainer",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x, train_labels=y, minibatch_size=batch),
        layers=[{"type": "attention",
                 "->": {"n_heads": HEADS, "causal": False}, "<-": gd},
                {"type": "layer_norm", "->": {}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": CLASSES},
                 "<-": gd}],
        decision_config={"max_epochs": 10 ** 6})
    wf.initialize(device=device)
    return wf


def train_flops(b: int) -> float:
    """Model FLOPs of one train step, ``benchmarks/seq_bench.py``'s
    count: the four D×D projections, the score and value products and
    the head, times three for forward and backward."""
    proj = 4 * 2.0 * b * SEQ * DIM * DIM
    scores = 2 * 2.0 * b * HEADS * SEQ * SEQ * (DIM // HEADS)
    head = 2.0 * b * SEQ * DIM * CLASSES
    return 3.0 * (proj + scores + head)


def step_breakdown(wf) -> None:
    """Device time of each unit of one train step, between CUDA events
    recorded around each call (the order of ``StandardWorkflow.step``)."""
    import torch
    loader = wf.loader
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    loader.run()
    mark("loader gather")
    acts = [loader.minibatch_data]
    with torch.enable_grad():
        for fwd in wf.forwards[:-1]:
            acts.append(fwd(acts[-1]))
            mark(type(fwd).__name__)
        probs, max_idx = wf.forwards[-1].classify(acts[-1])
        mark(type(wf.forwards[-1]).__name__)
    err = wf.evaluator.run(probs, max_idx, loader.minibatch_labels,
                           loader.minibatch_size, loader.minibatch_class)
    mark("EvaluatorSoftmax")
    for gd, x in zip(reversed(wf.gds), reversed(acts)):
        err = gd.run(x, err)
        mark(type(gd).__name__)
    wf.decision.run()
    torch.cuda.synchronize()
    parts = [f"{name} {a.elapsed_time(b):.4f} ms" for (_, a), (name, b)
             in zip(marks, marks[1:])]
    say("  per-unit device time of one train step: " + ", ".join(parts))


def device_busy(wf, steps: int = 3) -> None:
    """The device's busy share over a few steady train steps: the sum of
    the CUDA kernels' times in a ``torch.profiler`` window over the
    window's host time (which ends in a synchronize)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            wf.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    # kernels only: an operator's row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(device_ms(e) for e in kernels)
    if busy_ms <= 0.0:
        say("  device busy share: not measured (the profiler saw no "
            "device time)")
        return
    top = sorted(kernels, key=device_ms, reverse=True)[:10]
    say(f"  device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms over {steps} "
        f"profiled train steps ({100 * busy_ms / wall_ms:.1f} % busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f} % idle); kernels by time, "
        f"ms a step: " + "; ".join(f"{e.key[:48]} {device_ms(e) / steps:.3f}"
                                   for e in top))


def train_slice(kernels) -> dict:
    import math
    import numpy as np
    import torch
    from znicz_tpu_torch.loader.base import TRAIN
    rng = np.random.default_rng(SEED + 2)
    n = 4 * BATCH
    # the dataset resident in bf16, as seq_bench stores it
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(n, SEQ, DIM))
                         .astype(np.float32)).to(torch.bfloat16)
    y = rng.integers(0, CLASSES, size=n).astype(np.int32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wf = make_trainer(x, y, BATCH)
    say(f"  StandardWorkflow.initialize() on {wf.device} in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(type(u).__name__ for u in wf.forwards) + " / "
        + ", ".join(type(u).__name__ for u in wf.gds))
    if wf.device.type != "cuda":
        raise AssertionError(f"initialize() chose {wf.device}")
    for k in kernels:
        k.launches = 0
    warmup, steps = 2, 10
    for _ in range(warmup):
        wf.step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        wf.step()
    end.record()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    step_ms = start.elapsed_time(end) / steps
    say(f"  {warmup} + {steps} train steps (B={BATCH}, T={SEQ}, D={DIM}, "
        f"{HEADS} heads, bf16): launches {launches}")
    if any(v != warmup + steps for v in launches.values()):
        raise AssertionError(f"a kernel did not launch exactly once per "
                             f"train step: {launches}")
    loss = wf.decision.epoch_loss[TRAIN]
    if loss is None or not math.isfinite(loss):
        raise AssertionError(f"train loss {loss}")
    flops = train_flops(BATCH)
    say(f"  step {step_ms:.3f} ms, {BATCH * SEQ / step_ms * 1e3:.0f} "
        f"tokens/s, MFU {flops / (step_ms * 1e-3) / PEAK_BF16_FLOP_S:.4f} "
        f"({flops:.4g} FLOP/step against {PEAK_BF16_FLOP_S:.3g}), mean "
        f"train loss of the last epoch {loss:.4f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    step_breakdown(wf)
    device_busy(wf)
    del wf
    check_train_step_on_cpu(x[:2], y[:2])
    return launches


def check_train_step_on_cpu(x, y) -> None:
    """One train step (B=2, full T and D) on the card and on the CPU
    from the same seed and data: each parameter's update must agree."""
    import torch

    def one_step(device):
        wf = make_trainer(x, y, len(y), device)
        before = [p.detach().float().cpu().clone()
                  for u in wf.forwards for p in u.parameters()]
        wf.step()
        return [p.detach().float().cpu() - b for p, b in zip(
            (p for u in wf.forwards for p in u.parameters()), before)]

    t0 = time.perf_counter()
    card, cpu = one_step(None), one_step("cpu")
    worst = 0.0
    for got, want in zip(card, cpu):
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / max(scale, 1e-30)
        if not bool(torch.isfinite(got).all()) or scale == 0.0:
            raise AssertionError("an update is not finite or is zero")
        worst = max(worst, err)
    say(f"  one train step (B=2) on the card vs the CPU: {len(card)} "
        f"parameter updates, worst max|card − cpu| / max|cpu update| "
        f"{worst:.3g} (tol {TRAIN_STEP_TOL}), "
        f"{time.perf_counter() - t0:.1f} s")
    if worst > TRAIN_STEP_TOL:
        raise AssertionError("the card's train step disagrees with the "
                             "CPU's")


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
    spills = []
    for name in _cuda.SOURCES:
        stem = os.path.splitext(name)[0]
        for line in _cuda.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {stem}: {line.strip()}")
            spills += [(stem, line.strip()) for n in re.findall(
                r"(\d+) bytes spill", line) if int(n)]
    if spills:
        raise AssertionError(f"the compiler spilled registers: {spills}")

    say("phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {"flash_attention_fwd": check_flash(gen),
            "layer_norm_forward": check_layer_norm(gen),
            **check_flash_bwd(gen),
            "layer_norm_backward": check_layer_norm_bwd(gen)}

    say("phase 3: full-width bf16 scorer through ServingEngine")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scorer.npz")
        write_scorer_bundle(path)
        served = serve_slice(path, (fa.flash_attention_fwd,
                                    fk.layer_norm_forward))

    say("phase 4: full-width bf16 training through StandardWorkflow")
    trained = train_slice((fa.flash_attention_fwd, fk.layer_norm_forward,
                           fk.layer_norm_backward, fa.flash_attention_dq,
                           fa.flash_attention_dkv))
    for name, row in rows.items():
        row["launches"] = trained[name]
        row["launches_by_path"] = {"serving": served.get(name, 0),
                                   "training": trained[name]}

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
