"""The precision opt-outs of bf16 mode against the reference, on the CPU:
``engine.bf16_activations = False`` (activations and errors stored in
f32, the products' operands still bf16) and
``engine.bf16_optimizer_state = False`` (momentum stored in f32), each
set in the port and in the reference alike.

- The AlexNet slice of ``tests/test_torch_alexnet.py`` without its two
  LRNs (every other layer kind of AlexNet, cut to 35×35 inputs) trains
  six steps in bf16 from the reference's state with one opt-out set, and
  is held to the reference step by step at that file's bf16 slice
  tolerance (1e-4 of the largest |reference| of each tensor; measured
  7e-6), the reference run in a process of its own without XLA's excess
  precision, as there.  The stored dtypes are those the opt-out names,
  in both packages.
- The LRN (B1, B2) with the activations opt-out: both units take and
  give f32 in bf16 mode, held to the reference's units at
  ``tests/test_torch_lrn.py``'s f32 tolerance (2e-6).  The slice leaves
  the LRN out because its f32 output differs from the reference's XLA
  formula in the last f32 bits (within that tolerance), and the next
  conv's bf16 operands round such a difference one bf16 step apart now
  and then, which the first steps' cancelling conv updates magnify to
  a twentieth of their largest value: bf16 storage rounded the
  difference away.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_alexnet as slice_
from znicz_tpu_torch.loader.base import VALID
from znicz_tpu_torch.utils.config import reset_root, root

_REF_RUN = """
import pickle, sys
import test_torch_alexnet as t
from znicz_tpu.utils.config import root
setattr(root.common.engine, sys.argv[1], False)
t._slice_layers = lambda layers=t._slice_layers: [
    layer for layer in layers() if layer["type"] != "norm"]
ref = t._reference("bfloat16")
dtypes = [str(ref.forwards[0].act_store_dtype),
          str(ref.gds[0].opt_state_dtype)]
pickle.dump((t._reference_steps("bfloat16", 6), dtypes),
            open(sys.argv[2], "wb"))
"""


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _reference_steps(flag: str, tmp_path):
    out = tmp_path / "reference_steps.pkl"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_allow_excess_precision=false"]).strip(),
        PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests),
                                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REF_RUN, flag, str(out)],
                   check=True, env=env, timeout=300)
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("flag,act,state", [
    ("bf16_activations", torch.float32, torch.bfloat16),
    ("bf16_optimizer_state", torch.bfloat16, torch.float32)])
def test_opt_out_matches_the_reference(flag, act, state, tmp_path,
                                      monkeypatch):
    (ref_state, steps), ref_dtypes = _reference_steps(flag, tmp_path)
    layers = slice_._slice_layers
    monkeypatch.setattr(slice_, "_slice_layers", lambda: [
        layer for layer in layers() if layer["type"] != "norm"])
    assert ref_dtypes == [str(np.dtype(str(act).split(".")[-1]))
                          if act == torch.float32 else "bfloat16",
                          "float32" if state == torch.float32
                          else "bfloat16"]
    setattr(root.common.engine, flag, False)
    port = slice_._port("bfloat16", seed=3)
    port.load_reference_state(ref_state)
    conv = port.forwards[0]
    assert conv.act_store_dtype == act
    assert port.gds[0].opt_state_dtype == state
    assert port.gds[0].accumulated_gradient_weights.dtype == state
    for cls, want, losses, n_err in steps:
        before = slice_._port_tensors(port)
        port.step()
        assert port.loader.minibatch_class == cls
        after = slice_._port_tensors(port)
        if cls == VALID:
            for key in before:
                np.testing.assert_array_equal(after[key], before[key])
        slice_._assert_close(after, want, "bfloat16")
        assert all(u.output.dtype == act for u in port.forwards[:-1])
    assert list(port.decision.last_epoch_n_err) == n_err


@pytest.mark.parametrize("n", [5, 4])
def test_lrn_takes_f32_activations_in_bf16_mode(n):
    """With ``bf16_activations`` off the LRN units store f32 in bf16
    mode, as the reference's do, and agree with them at the f32
    tolerance."""
    from test_torch_lrn import ALEXNET, F32_TOL, _ref_lrn, _rel
    from znicz_tpu.utils.config import root as ref_root
    from znicz_tpu_torch.ops.normalization import (LRNormalizerBackward,
                                                   LRNormalizerForward)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(0, 30, (2, 5, 4, 12)).astype(
        np.float32))
    err = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    # the reference's XLA path rounds the denominator to bf16 unless
    # told not to; the port follows its Pallas kernel, which does not
    ref_root.common.engine.bf16_activations = False
    ref_root.common.engine.lrn_d_bf16 = False
    try:
        want_y, want_dx = _ref_lrn(x.numpy(), err.numpy(), "bfloat16", n)
    finally:
        ref_root.common.engine.bf16_activations = True
        ref_root.common.engine.lrn_d_bf16 = True
    root.common.engine.bf16_activations = False
    unit = LRNormalizerForward(tuple(x.shape[1:]), torch.bfloat16, n=n,
                               **ALEXNET)
    gd = LRNormalizerBackward(unit, need_err_input=True)
    y = unit(x)
    dx = gd.run(x, err, y)
    assert unit.act_store_dtype == y.dtype == dx.dtype == torch.float32
    assert _rel(y, want_y) <= F32_TOL
    assert _rel(dx, want_dx) <= F32_TOL
