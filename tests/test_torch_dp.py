"""Data parallelism and ZeRO-1 in spawned gloo worlds of four CPU ranks
(counterparts of ``tests/test_parallel.py``'s data-parallel cases and
``tests/test_zero1.py``).

One world a module trains every arm and returns the results
(``tests/torch_parallel_worker.py``); the tests hold them to the port on
one device, to the reference's runs on its virtual 8-device mesh, and
to each other.  Tolerances: a data-parallel run against one device
1e-5 (the fold reorders sums; measured ~3e-8), against the reference's
mesh its own DP tolerance (rtol 1e-3, atol 1e-4); ZeRO-1 against the
replicated update on the same mesh the reference's ``TIGHT`` (rtol 1e-5,
atol 1e-6), bf16 state its bf16 band (rtol 1e-2, atol 1e-3), the bf16
reduce-scatter (``engine.bf16_grad_comms``) its band (rtol 0.05, atol
5e-3).
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from tests.conftest import make_blobs

RANKS = 4
TIGHT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    return worker.spawn_world("dp", RANKS, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def zero1_world(tmp_path_factory):
    return worker.spawn_world("zero1", RANKS,
                              tmp_path_factory.mktemp("zero1"))


def port_single(**kw):
    """The same run on one CPU device with no mesh."""
    from znicz_tpu_torch.backends import CpuDevice
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.engine.zero1 = "auto"
    prng.seed_all(kw.pop("seed", 1234))
    wf = worker.build_fc(**kw)
    wf.initialize(device=CpuDevice(torch.device("cpu")))
    wf.run()
    return wf


def reference_run(mesh: bool, **kw):
    """The reference's ``test_parallel`` run on one device or its
    8-device data mesh."""
    from znicz_tpu.backends import XLADevice
    from znicz_tpu.loader.fullbatch import ArrayLoader
    from znicz_tpu.models.standard_workflow import StandardWorkflow
    from znicz_tpu.parallel import make_mesh
    from znicz_tpu.utils import prng
    data, labels = make_blobs(40, 3, 12)
    prng.seed_all(1234)
    wf = StandardWorkflow(
        name="dp",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=24),
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}],
        decision_config={"max_epochs": 1})
    wf._max_fires = 100_000
    wf.initialize(device=XLADevice(mesh=make_mesh() if mesh else None))
    wf.run()
    out = []
    for fwd in wf.forwards:
        for vec in (fwd.weights, fwd.bias):
            vec.map_read()
            out.append(np.array(vec.mem, copy=True))
    return out, wf.decision.min_validation_n_err


def test_ranks_end_with_the_same_weights(dp_world):
    for arm in ("replicated", "zero1"):
        for other in dp_world[1:]:
            for a, b in zip(dp_world[0][arm]["params"], other[arm]["params"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arm", ["replicated", "zero1"])
def test_dp_matches_single_device(dp_world, arm):
    single = port_single(hidden2=None)
    got = dp_world[0][arm]
    for a, b in zip(worker.params(single), got["params"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    assert got["err"] == single.decision.min_validation_n_err


def test_dp_matches_the_reference_data_mesh(dp_world):
    ref, err = reference_run(mesh=True)
    got = dp_world[0]["replicated"]
    for a, b in zip(ref, got["params"]):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    assert got["err"] == err


def test_dp_batch_actually_sharded(dp_world):
    """Each rank gathers its 24 / 4 rows; ZeRO-1 engaged on the arm that
    asks for it only."""
    for rank in dp_world:
        assert rank["replicated"]["local_rows"] == 24 // RANKS
        assert rank["replicated"]["zero1"] == []
        assert rank["zero1"]["zero1"] == ["bias", "weights"]


def test_run_chunked_on_the_data_mesh(dp_world):
    """Chunks of 4 steps a dispatch compose with the fold: two epochs
    as on one device."""
    from znicz_tpu_torch.backends import CpuDevice
    from znicz_tpu_torch.utils import prng
    prng.seed_all(1234)
    wf = worker.build_fc(hidden2=None, max_epochs=2)
    wf.initialize(device=CpuDevice(torch.device("cpu")))
    wf.run_chunked(4)
    for a, b in zip(worker.params(wf), dp_world[0]["chunked"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_run_accumulated_folds_once_at_apply(dp_world):
    """Two microbatches an optimizer step on the data mesh (ZeRO-1 on):
    the fold runs at the apply microbatch only, and the run lands where
    one device's accumulated run does."""
    from znicz_tpu_torch.backends import CpuDevice
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.engine.grad_accum = 2
    try:
        prng.seed_all(1234)
        wf = worker.build_fc(hidden2=None)
        wf.initialize(device=CpuDevice(torch.device("cpu")))
        wf.run_accumulated(2)
    finally:
        root.common.engine.grad_accum = 1
    for a, b in zip(worker.params(wf), dp_world[0]["accumulated"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_indivisible_minibatch_clamped(dp_world):
    assert all(rank["clamped"] == 20 for rank in dp_world)  # 21 → 20


def test_unshardable_minibatch_rejected(dp_world):
    for rank in dp_world:
        assert rank["unshardable"] is not None
        assert "sharded" in rank["unshardable"]


def test_process_shard_across_four_processes(dp_world):
    """``allgather_sum`` in float64 in process order, bit-exact;
    ``broadcast_from_zero``; ``merge_round_robin`` (job i from process
    i % 4 at its slot i // 4)."""
    parts = [np.array([r + 2.0 ** -40, -1e300 * (r == 0), 3.0], np.float64)
             for r in range(RANKS)]
    want_sum = parts[0] + parts[1] + parts[2] + parts[3]
    want_merged = np.array([10.0 * (i // RANKS) + i % RANKS
                            for i in range(10)])
    for rank, got in enumerate(dp_world):
        got = got["process_shard"]
        assert got["info"] == (rank, RANKS)
        assert got["sum"].dtype == np.float64
        np.testing.assert_array_equal(got["sum"], want_sum)
        np.testing.assert_array_equal(got["bcast"],
                                      np.arange(3, dtype=np.float64) * np.pi)
        np.testing.assert_array_equal(got["merged"], want_merged)


@pytest.mark.parametrize("arm", list(worker.ZERO1_ARMS))
def test_zero1_matches_replicated(zero1_world, arm):
    got = zero1_world[0][arm]
    tol = dict(rtol=1e-2, atol=1e-3) if arm == "bf16_state" else TIGHT
    for a, b in zip(got["replicated"], got["zero1"]):
        np.testing.assert_allclose(b, a, **tol)
    if arm == "bf16_state":
        assert got["dtype"] == "torch.bfloat16"
    for rank in zero1_world[1:]:
        for a, b in zip(got["zero1"], rank[arm]["zero1"]):
            np.testing.assert_array_equal(a, b)


def test_zero1_bf16_grad_comms_parity(zero1_world):
    """The bf16 reduce-scatter (``engine.bf16_grad_comms``, off by
    default; the port of ``tests/test_zero1.py``'s parity test): within
    the reference test's bf16 band (rtol 0.05, atol 5e-3) of the f32
    reduce-scatter on the same mesh, and of the reference's bf16 arm on
    its mesh; every rank the same weights."""
    from tests.test_zero1 import run_arm
    from znicz_tpu.utils.config import root as ref_root
    got = zero1_world[0]["bf16_grad_comms"]
    assert any(got["flags"]) and not any(got["default_flags"])
    ref_root.common.engine.bf16_grad_comms = True
    try:
        ref, _ = run_arm("auto", gd_extra={"weights_decay": 0.01})
    finally:
        ref_root.common.engine.bf16_grad_comms = False
    for f32, want, b in zip(zero1_world[0]["momentum_l2"]["zero1"], ref,
                            got["params"]):
        np.testing.assert_allclose(b, f32, rtol=0.05, atol=5e-3)
        np.testing.assert_allclose(b, want, rtol=0.05, atol=5e-3)
    for rank in zero1_world[1:]:
        for a, b in zip(got["params"], rank["bf16_grad_comms"]["params"]):
            np.testing.assert_array_equal(a, b)


def test_zero1_plans_follow_zero1_partition(zero1_world):
    """Each momentum's (dim, pad) is the reference's ``zero1_partition``
    of its weights, and each rank stores 1/4 of the padded dim."""
    from znicz_tpu.parallel import zero1_partition
    shapes = {"momentum_l2": [(12, 16), (16, 8), (8, 3)],
              "padding": [(12, 13), (13, 7), (7, 3)]}
    for arm, weights in shapes.items():
        got = zero1_world[0][arm]
        for shape, plan, acc in zip(weights, got["plans"], got["accs"]):
            dim, pad = zero1_partition(shape, RANKS)
            assert plan == (dim, pad)
            want = list(shape)
            want[dim] = (shape[dim] + pad) // RANKS
            assert acc.shape == tuple(want)


def test_zero1_padding_rows_stay_zero(zero1_world):
    """The last rank's slice of the (13, 7) momentum holds the 3 pad
    rows: exact zeros after an epoch."""
    acc = zero1_world[-1]["padding"]["accs"][1]
    np.testing.assert_array_equal(acc[-3:], 0.0)
    assert np.abs(acc[:-3]).max() > 0


def test_zero1_snapshot_holds_logical_shapes_and_resumes_on_one_device(
        zero1_world):
    """The snapshot gathers the sharded momentum back to the weights'
    shapes; resumed on one device with no mesh, the second epoch lands
    where the four ranks' did."""
    from znicz_tpu_torch.backends import CpuDevice
    from znicz_tpu_torch.utils import prng
    snap = zero1_world[0]["snapshot"]
    units = snap["state"]["__units__"]
    shapes = sorted(tuple(v.shape) for u in units.values()
                    for k, v in u.items()
                    if k == "accumulated_gradient_weights")
    assert shapes == sorted([(12, 16), (16, 8), (8, 3)])
    prng.seed_all(1)
    wf = worker.build_fc(gd_extra={"weights_decay": 0.01}, max_epochs=2)
    wf.initialize(device=CpuDevice(torch.device("cpu")))
    wf.load_state(snap["state"])
    wf.run()
    for a, b in zip(worker.params(wf), snap["after"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_zero1_shard_and_gather_round_trip_with_pad(zero1_world):
    for rank in zero1_world:
        rt = rank["roundtrip"]
        assert rt["pad"] == 2 and rt["local"] == (3, 6)
        np.testing.assert_array_equal(
            rt["back"], np.arange(60, dtype=np.float32).reshape(10, 6))
