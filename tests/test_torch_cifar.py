"""The port's CIFAR-10 sample against the reference's, on the CPU.

The sample at its full widths (minibatch 100, 32×32×3 images, kernels
32, 32 and 64): the synthetic stand-in byte for byte, the configuration
and layer list, the initial state from one seed, and three train steps
through the reference's ``StandardWorkflow`` and the port's
(``device="cpu"``) from the same state, the reference's carried over by
``load_state``.  Both start at the first train minibatch of epoch 0 (the
loader's cursor moved past the 10 test and 5 validation minibatches),
so the steps exercise every backward unit: the MaxAbs and average
pools, the two LRNs (B1, B2 on the card) and the softmax head (B4).

Tolerances:

- float32: 1e-5 of the largest |reference| of each tensor (summation
  order only: the convolutions, the window sums of the average pools
  and the errors of overlapping windows);
- bfloat16: the reference runs in a process of its own with
  ``xla_allow_excess_precision`` off, as ``tests/test_torch_alexnet.py``
  runs it, and with ``engine.lrn_d_bf16`` off (the port follows the
  reference's Pallas LRN, which keeps d in f32).  The two do not round
  at the same points: the port's pools sum in f32 and round once, where
  the reference's add bf16 values in bf16 (the average's window sums and
  the errors of overlapping windows), so single bf16 roundings of pooled
  activations and errors differ, and they reach every gradient.  The
  yardstick is each tensor's own rounding noise, from the same state:
  the reference's bf16 tensor against its f32 tensor.  Two bf16 runs
  whose roundings were independent would differ by about √2 of it;
  ``‖port − reference‖ ≤ 1.5·‖reference bf16 − reference f32‖`` holds
  them to that (measured: at most 0.97), and a fault in a pool's
  window, divisor or scatter moves the tensors by far more.
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from znicz_tpu import datasets as ref_datasets
from znicz_tpu.backends import XLADevice
from znicz_tpu.models.samples import cifar as ref_cifar
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch import datasets
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.models.samples import cifar
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root, root

#: f32: max |port − reference| / max |reference|
TOL_F32 = 1e-5
#: bf16: ‖port − reference‖ / ‖reference bf16 − reference f32‖
NOISE_FACTOR_BF16 = 1.5
#: the first train minibatch of an epoch: after 10 test and 5
#: validation minibatches
FIRST_TRAIN = 15
SEED = 31
_STATE_ATTRS = ("weights", "bias", "accumulated_gradient_weights",
                "accumulated_gradient_bias")


@pytest.fixture(autouse=True)
def port_config(tmp_path):
    """The port's root reset around each test (the reference's is reset
    by ``tests/conftest.py``)."""
    reset_root()
    # no real batches: both packages take the synthetic stand-in
    root.common.dirs.datasets = str(tmp_path / "no_datasets")
    root.common.dirs.snapshots = str(tmp_path / "snapshots")
    yield
    reset_root()


def _read(vec) -> np.ndarray:
    vec.map_read()
    return np.asarray(vec.mem).astype(np.float32)


def _ref_tensors(wf) -> dict:
    out = {}
    for unit in [*wf.forwards, *wf.gds]:
        for attr in _STATE_ATTRS:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                out[f"{unit.name}.{attr}"] = _read(vec)
    return out


def _port_tensors(wf) -> dict:
    return {f"{unit.name}.{name}": t.detach().float().numpy().copy()
            for unit in [*wf.forwards, *wf.gds]
            for name, t in [*unit.named_parameters(recurse=False),
                            *unit.named_buffers(recurse=False)]}


def _reference_steps(dtype: str, n: int, datasets_dir: str):
    """The reference sample built from ``SEED`` and moved to the first
    train minibatch: its initial tensors, its state, then its tensors
    after each of ``n`` steps."""
    ref_root.common.dirs.datasets = datasets_dir
    ref_root.common.precision_type = dtype
    ref_root.common.engine.lrn_d_bf16 = False  # the Pallas kernels' d
    ref_prng.seed_all(SEED)
    wf = ref_cifar.build()
    wf.initialize(device=XLADevice())
    initial = _ref_tensors(wf)
    loader = copy.deepcopy(wf.loader.state_dict())
    loader["_cursor"] = FIRST_TRAIN
    wf.loader.load_state(loader)  # the device-resident cursor too
    state = copy.deepcopy(wf.state_dict())  # not live views
    steps = []
    for _ in range(n):
        wf.loader._fire()
        wf._region_unit._fire()
        wf.decision._fire()
        steps.append((wf.loader.minibatch_class, _ref_tensors(wf)))
    return initial, state, steps


@pytest.fixture(scope="module")
def reference_f32(tmp_path_factory):
    """The reference's f32 run, built once for the module (one XLA
    compile of the CIFAR region)."""
    missing = str(tmp_path_factory.mktemp("no_datasets"))
    try:
        return _reference_steps("float32", 3, missing)
    finally:
        ref_root.common.precision_type = "float32"


_REF_RUN = """
import pickle, sys
import test_torch_cifar as t
pickle.dump(t._reference_steps(sys.argv[1], 3, sys.argv[3]),
            open(sys.argv[2], "wb"))
"""


def _reference_steps_without_excess_precision(dtype, tmp_path):
    """:func:`_reference_steps` in a fresh process whose XLA keeps every
    bf16 rounding the program asks for (the flag is read once per
    process)."""
    out = tmp_path / "reference_steps.pkl"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         "--xla_allow_excess_precision=false"]).strip(),
        PYTHONPATH=os.pathsep.join([tests, os.path.dirname(tests),
                                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REF_RUN, dtype, str(out),
                    str(tmp_path / "no_datasets")],
                   check=True, env=env, timeout=300)
    with open(out, "rb") as f:
        return pickle.load(f)


def _port(dtype: str, seed: int = SEED):
    root.common.precision_type = dtype
    prng.seed_all(seed)
    wf = cifar.build(snapshotter_config=None)
    wf.initialize(device="cpu")
    return wf


def test_stand_in_is_the_reference_bytes(tmp_path):
    ref_root.common.dirs.datasets = str(tmp_path / "no_datasets")
    got, want = datasets.load_cifar10(), ref_datasets.load_cifar10()
    assert [a.shape for a in got] == [(5000, 32, 32, 3), (5000,),
                                      (1000, 32, 32, 3), (1000,)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_real_batches_are_read_as_the_reference_reads_them(tmp_path):
    """Six binary batches (a label byte, then 3·32·32 pixels in CHW
    order, per record) under ``<datasets>/cifar-10-batches-bin``: both
    packages give the same NHWC arrays."""
    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    rng = np.random.default_rng(4)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        rng.integers(0, 256, (3, 3073), dtype=np.uint8).tofile(base / name)
    root.common.dirs.datasets = ref_root.common.dirs.datasets = str(tmp_path)
    got, want = datasets.load_cifar10(), ref_datasets.load_cifar10()
    assert got[0].shape == (15, 32, 32, 3) and got[2].shape == (3, 32, 32, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sample_matches_the_reference_sample():
    cfg = dict(root.cifar.as_dict())
    assert cfg.pop("snapshotter_config") == {"prefix": "cifar"}
    assert cfg == dict(ref_root.cifar.as_dict())
    assert cifar.layers(cfg) == ref_cifar.layers(cfg)
    wf = cifar.build(max_epochs=3)
    assert wf.decision.max_epochs == 3
    assert wf.snapshotter.prefix == "cifar"
    assert wf.snapshotter.directory == str(root.common.dirs.snapshots)
    assert cifar.build(snapshotter_config=None).snapshotter is None


def test_same_seed_gives_the_reference_initial_state(reference_f32):
    initial, _, _ = reference_f32
    port = _port("float32")
    got = _port_tensors(port)
    assert set(got) == set(initial)
    for key in initial:
        np.testing.assert_array_equal(got[key], initial[key], err_msg=key)
    assert [u.output_shape for u in port.forwards] == [
        (32, 32, 32), (16, 16, 32), (16, 16, 32), (16, 16, 32), (8, 8, 32),
        (8, 8, 32), (8, 8, 64), (4, 4, 64), (10,)]
    assert port.loader.class_lengths == [1000, 500, 4500]


def test_train_steps_match_the_reference_f32(reference_f32):
    _, state, steps = reference_f32
    port = _port("float32", seed=3)  # every weight must come from the state
    port.load_state(state)
    for cls, want in steps:
        port.step()
        assert port.loader.minibatch_class == cls == TRAIN
        got = _port_tensors(port)
        assert set(got) == set(want)
        for key, w in want.items():
            err = float(np.abs(got[key] - w).max())
            scale = max(float(np.abs(w).max()), 1e-30)
            assert err <= TOL_F32 * scale, f"{key}: {err / scale}"


def test_train_steps_match_the_reference_bf16(reference_f32, tmp_path):
    _, _, steps_f32 = reference_f32
    _, state, steps = _reference_steps_without_excess_precision(
        "bfloat16", tmp_path)
    port = _port("bfloat16", seed=3)
    port.load_state(state)
    for (cls, want), (_, want_f32) in zip(steps, steps_f32):
        port.step()
        assert port.loader.minibatch_class == cls == TRAIN
        got = _port_tensors(port)
        assert set(got) == set(want)
        for key, w in want.items():
            diff = float(np.linalg.norm(got[key] - w))
            noise = float(np.linalg.norm(w - want_f32[key]))
            assert diff <= NOISE_FACTOR_BF16 * noise, \
                f"{key}: ‖port − ref‖ {diff} > {NOISE_FACTOR_BF16}·{noise}"
