#!/usr/bin/env python3
"""Train the full-width sequence stack of ``chip_smoke.py`` (B = 16,
T = 2048, D = 512, 8 heads, momentum 0.9) on the card, eagerly, from
the script's seed and data, and report where it goes non-finite.

Each run prints a line a step: the guard's ``(streak, loss, grad)``
state, the largest finite |value| of each parameter and of each
forward's output.  Between the units of every step it reads every
floating tensor of the workflow, and names the first unit after which
one holds a non-finite value.  The runs (``--runs``, all by default):

- ``bf16``: bf16 through the hand-written kernels, at ``--lr``;
- ``bf16-plain``: the same with every kernel wrapper of the path
  (flash forward and backward, layer norm, softmax) replaced by its
  plain PyTorch version;
- ``f32``: f32 through the kernels;
- ``bf16-low``: bf16 through the kernels at each rate of
  ``--low-lr``, ``--steps`` steps, the final state only.

Run from the root of a checkout on a machine with one card::

    python3 tools/seq_divergence.py --steps 40

Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from znicz_tpu_torch.ops import all2all, layer_norm  # noqa: E402
from znicz_tpu_torch.ops import flash_attention as fa  # noqa: E402
from znicz_tpu_torch.ops import fused_kernels as fk  # noqa: E402

RUNS = ("bf16", "bf16-plain", "f32", "bf16-low")
KERNELS = {(fa, "flash_attention_fwd"): fa.flash_attention_fwd,
           (fa, "flash_attention_dq"): fa.flash_attention_dq,
           (fa, "flash_attention_dkv"): fa.flash_attention_dkv,
           (layer_norm, "layer_norm_forward"): layer_norm.layer_norm_forward,
           (layer_norm, "layer_norm_backward"):
               layer_norm.layer_norm_backward,
           (all2all, "softmax_argmax"): all2all.softmax_argmax}


def _fwd_plain(q, k, v, causal=False, q_offset=0, k_offset=0):
    return fa.flash_attention_plain(q, k, v, causal, q_offset, k_offset)


PLAIN = {(fa, "flash_attention_fwd"): _fwd_plain,
         (fa, "flash_attention_dq"): fa.flash_attention_dq_plain,
         (fa, "flash_attention_dkv"): fa.flash_attention_dkv_plain,
         (layer_norm, "layer_norm_forward"): fk.layer_norm_forward_plain,
         (layer_norm, "layer_norm_backward"): fk.layer_norm_backward_plain,
         (all2all, "softmax_argmax"): fk.softmax_argmax_plain}


def use_plain(on: bool) -> None:
    """Every kernel wrapper of the path, or its plain version, where the
    units call it."""
    for (module, name), fn in (PLAIN if on else KERNELS).items():
        setattr(module, name, fn)


def build(x, y, precision: str, lr: float):
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.precision_type = precision
    prng.seed_all(cs.SEED)
    gd = dict(cs.SEQ_GD, learning_rate=lr)
    wf = StandardWorkflow(
        name="seq_divergence",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=x, train_labels=y, minibatch_size=cs.BATCH),
        layers=[{"type": "attention",
                 "->": {"n_heads": cs.HEADS, "causal": False}, "<-": gd},
                {"type": "layer_norm", "->": {}, "<-": gd},
                {"type": "softmax", "->": {"output_sample_shape": cs.CLASSES},
                 "<-": gd}],
        decision_config={"max_epochs": 10 ** 6})
    wf.initialize()
    return wf


def tensors(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, wf.evaluator, *wf.gds]:
        for key, val in list(vars(unit).items()):
            if isinstance(val, torch.Tensor) and val.is_floating_point() \
                    and val.numel() > 1:
                out[f"{unit.name}.{key}"] = val
        if isinstance(unit, torch.nn.Module):
            for key, val in [*unit.named_parameters(recurse=False),
                             *unit.named_buffers(recurse=False)]:
                if val.is_floating_point():
                    out[f"{unit.name}.{key}"] = val
    return out


def largest(t: torch.Tensor) -> tuple[float, int]:
    """The largest finite |value| and the count of non-finite values."""
    t = t.detach().float()
    fin = torch.isfinite(t)
    return (float(t.abs().where(fin, torch.zeros_like(t)).max()),
            int((~fin).sum()))


def run(label: str, precision: str, plain: bool, lr: float, steps: int,
        verbose: bool) -> None:
    use_plain(plain)
    rng = np.random.default_rng(cs.SEED + 2)  # phase 8's data
    x = torch.from_numpy(rng.normal(0.0, 0.3, size=(
        4 * cs.BATCH, cs.SEQ, cs.DIM)).astype(np.float32))
    if precision == "bfloat16":
        x = x.to(torch.bfloat16)
    y = rng.integers(0, cs.CLASSES, size=4 * cs.BATCH).astype(np.int32)
    wf = build(x, y, precision, lr)
    first_bad = None
    for step in range(steps):
        found = []

        def mark(unit_name):
            if first_bad is not None or found:
                return
            torch.cuda.synchronize()
            for key, val in tensors(wf).items():
                _, bad = largest(val)
                if bad:
                    found.append(f"after {unit_name}: {key} ({bad})")
        wf.step(mark)
        state = wf.anomaly_guard.read_state()
        if verbose:
            params = {k: largest(v)[0] for k, v in tensors(wf).items()
                      if k.rsplit(".", 1)[1] in ("weights", "bias",
                                                 "weights_out", "bias_out")}
            outs = {k.split(".")[0]: largest(v)[0]
                    for k, v in tensors(wf).items() if k.endswith(".output")}
            print(f"{label} step {step}: state {state} |params| "
                  + " ".join(f"{k}={v:.3g}" for k, v in params.items())
                  + " |out| " + " ".join(f"{k}={v:.3g}"
                                         for k, v in outs.items()),
                  flush=True)
        if found and first_bad is None:
            first_bad = step
            print(f"{label} first non-finite tensor at step {step}: "
                  + "; ".join(found[:8]), flush=True)
    use_plain(False)
    print(f"{label} (lr {lr}) after {steps} steps: state "
          f"{wf.anomaly_guard.read_state()}, first non-finite tensor at "
          f"step {first_bad}", flush=True)
    del wf
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--low-lr", type=float, nargs="+", default=[1e-3, 1e-4])
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cs.set_graphs(False)  # a marked step runs eagerly in any case
    for name in args.runs:
        if name == "bf16":
            run(name, "bfloat16", False, args.lr, args.steps, True)
        elif name == "bf16-plain":
            run(name, "bfloat16", True, args.lr, args.steps, True)
        elif name == "f32":
            run(name, "float32", False, args.lr, args.steps, False)
        else:
            for lr in args.low_lr:
                run(name, "bfloat16", False, lr, args.steps, False)


if __name__ == "__main__":
    main()
