"""The parallel package's host code against the reference in-process
(the env contract, the mesh arithmetic, ``zero1_partition``, the
partition-rule engine, ``process_shard`` on one process), and tensor
parallelism in a spawned gloo world of four CPU ranks on a 2 × 2
(data, model) mesh (counterparts of ``tests/test_parallel.py``'s TP
cases, ``tests/test_partition.py`` and ``tests/test_process_shard.py``).

Tolerances: TP against replicated on the same mesh rtol 1e-3, atol 1e-4
(the reference's); the rules arm against the legacy arm bit for bit;
the TP bundle served on one device against the replicated bundle rtol
5e-3, atol 1e-4 (the reference's).
"""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as worker
from znicz_tpu.parallel import mesh as ref_mesh
from znicz_tpu.parallel import partition as ref_partition
from znicz_tpu_torch.parallel import distributed, mesh, partition
from znicz_tpu_torch.parallel import process_shard
from znicz_tpu_torch.parallel.axis import DATA_AXIS, MODEL_AXIS

RANKS = 4


# ----------------------------------------------------------------------
# host code, in-process
# ----------------------------------------------------------------------
@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"ZNICZ_COORDINATOR": "10.0.0.1:1234"},
     {"coordinator_address": "10.0.0.1:1234"}),
    ({"ZNICZ_COORDINATOR": "h:1", "ZNICZ_NUM_PROCESSES": "4",
      "ZNICZ_PROCESS_ID": "3"},
     {"coordinator_address": "h:1", "num_processes": 4, "process_id": 3}),
])
def test_env_spec_is_the_reference_contract(monkeypatch, env, want):
    from znicz_tpu.parallel import distributed as ref_distributed
    for key in ("ZNICZ_COORDINATOR", "ZNICZ_NUM_PROCESSES",
                "ZNICZ_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert distributed.env_spec() == want == ref_distributed.env_spec()


def test_nothing_requested_starts_nothing(monkeypatch):
    monkeypatch.delenv("ZNICZ_COORDINATOR", raising=False)
    assert distributed.ensure_initialized(device_type="cpu") is False
    assert distributed.process_info() == (0, 1)
    with pytest.raises(ValueError, match="process count"):
        distributed.ensure_initialized(coordinator="127.0.0.1:1",
                                       device_type="cpu")
    with pytest.raises(ValueError, match="outside"):
        distributed.ensure_initialized(coordinator="127.0.0.1:1",
                                       num_processes=2, process_id=2,
                                       device_type="cpu")


def test_backend_follows_the_device():
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        distributed.backend_for("numpy")


@pytest.mark.parametrize("shape,n,model_dim", [
    ((12, 16), 8, None), ((576, 32), 8, None), ((12, 16), 8, 1),
    ((13, 5), 8, None), ((), 8, None), ((16,), 1, None),
    ((12, 13), 4, None), ((13, 7), 4, None), ((7, 3), 4, None),
    ((10, 6), 4, None), ((12, 16), 2, 1),
])
def test_zero1_partition_is_the_reference(shape, n, model_dim):
    assert mesh.zero1_partition(shape, n, model_dim) \
        == ref_mesh.zero1_partition(shape, n, model_dim)


def test_spec_arithmetic_is_the_reference():
    ref = ref_mesh.make_mesh(n_data=4, n_model=2)
    sizes = {DATA_AXIS: 4, MODEL_AXIS: 2}
    for shape, spec in (((8, 16), (DATA_AXIS, MODEL_AXIS)),
                        ((8, 15), (DATA_AXIS, MODEL_AXIS)),
                        ((6, 16), (DATA_AXIS, None)),
                        ((8, 16, 4), (None, MODEL_AXIS, None))):
        assert mesh.spec_divides(sizes, shape, spec) \
            == ref_mesh.spec_divides(ref, shape, P(*spec))
        if mesh.spec_divides(sizes, shape, spec):
            assert mesh.shard_shape(sizes, shape, spec) \
                == ref_mesh.shard_shape(ref, shape, P(*spec))


class _Mesh:
    """An axis-size stand-in for the gates (no process group)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def size(self, axis):
        return self.shape.get(axis, 1)


def test_zero1_choice_gates():
    from znicz_tpu_torch.backends import CpuDevice, NumpyDevice
    from znicz_tpu_torch.utils.config import root
    import torch
    cpu = torch.device("cpu")
    assert not mesh.zero1_choice(None)
    assert not mesh.zero1_choice(CpuDevice(cpu))
    assert not mesh.zero1_choice(NumpyDevice(cpu))
    dev = CpuDevice(cpu)
    dev.mesh = _Mesh(data=1, model=2)
    assert not mesh.zero1_choice(dev)
    dev.mesh = _Mesh(data=2, model=1)
    assert mesh.zero1_choice(dev)
    root.common.engine.zero1 = False
    try:
        assert not mesh.zero1_choice(dev)
    finally:
        root.common.engine.zero1 = "auto"
    with pytest.raises(ValueError, match="numpy oracle"):
        NumpyDevice(cpu, mesh=_Mesh(data=2))


def test_process_shard_single_process():
    assert process_shard.process_info() == (0, 1)
    scores = np.array([1.5, 2.5, 3.5])
    np.testing.assert_array_equal(
        process_shard.merge_sharded_scores(scores, 1), scores)
    np.testing.assert_array_equal(
        process_shard.merge_round_robin([4.0, 5.0, 6.0], 0, 1, 3),
        [4.0, 5.0, 6.0])
    x = np.array([1e300, -2.0 ** -1074, np.pi], np.float64)
    out = process_shard.allgather_sum(x)
    assert out.dtype == np.float64 and np.array_equal(out, x)
    np.testing.assert_array_equal(process_shard.broadcast_from_zero(x), x)


# -- the partition-rule engine, against the reference's ---------------
def _both():
    return partition.PartitionTable("t"), ref_partition.PartitionTable("t")


def _same(res, ref):
    assert tuple(res.spec) == tuple(ref.spec)
    for attr in ("rule", "batch_major", "model_shard_dim",
                 "model_shard_axis", "data_shard_dim", "data_shard_pad",
                 "member_axis", "logical_shape", "stage"):
        assert getattr(res, attr) == getattr(ref, attr), attr
    assert res.padded_shape() == ref.padded_shape()


@pytest.mark.parametrize("path,shape", [
    ("fc1/weird", ()), ("fc1/weird", (1,)), ("fc1/weird", (1, 1))])
def test_scalar_short_circuits_before_rules(path, shape):
    t, r = _both()
    t.declare(r".*", (DATA_AXIS,))
    r.declare(r".*", P(DATA_AXIS))
    _same(t.resolve(path, shape), r.resolve(path, shape))


def test_first_match_wins_in_declaration_order():
    t, r = _both()
    t.declare(r"/weights$", (None, MODEL_AXIS))
    t.declare(r"fc1/weights$", (MODEL_AXIS,))
    r.declare(r"/weights$", P(None, MODEL_AXIS))
    r.declare(r"fc1/weights$", P(MODEL_AXIS))
    _same(t.resolve("fc1/weights", (8, 16), n_data=4),
          r.resolve("fc1/weights", (8, 16), n_data=4))


def test_unmatched_leaf_is_hard_error():
    with pytest.raises(partition.UnmatchedLeafError, match="no rule"):
        partition.PartitionTable("t").resolve("fc1/not_a_slot", (4, 4))


def test_redeclare_replaces_in_place():
    t, r = _both()
    t.declare_leaf("fc1/output", (DATA_AXIS, MODEL_AXIS))
    t.declare_leaf("fc1/output", partition.BATCH)
    r.declare_leaf("fc1/output", P(DATA_AXIS, MODEL_AXIS))
    r.declare_leaf("fc1/output", ref_partition.BATCH)
    _same(t.resolve("fc1/output", (8, 16), n_data=4),
          r.resolve("fc1/output", (8, 16), n_data=4))
    assert t.dump()[0][1] == r.dump()[0][1] == "BATCH"


@pytest.mark.parametrize("shape,n,model_dim", [
    ((10, 16), 8, 1), ((13, 7), 4, None), ((12, 16), 2, 1)])
def test_zero1_dim_and_pad_are_rule_consequences(shape, n, model_dim):
    t, r = _both()
    t.declare_leaf("gd/acc", partition.Zero1(model_dim=model_dim))
    r.declare_leaf("gd/acc", ref_partition.Zero1(model_dim=model_dim))
    _same(t.resolve("gd/acc", shape, n_data=n),
          r.resolve("gd/acc", shape, n_data=n))


@pytest.mark.parametrize("shape", [(8, 12, 16), (6, 12, 16)])
def test_member_divisibility_is_a_rule_consequence(shape):
    t, r = _both()
    t.declare_leaf("pop/fc1.weights", partition.Member(model_dim=2))
    r.declare_leaf("pop/fc1.weights", ref_partition.Member(model_dim=2))
    _same(t.resolve("pop/fc1.weights", shape, n_data=4),
          r.resolve("pop/fc1.weights", shape, n_data=4))


def test_member_model_dim_zero_rejected():
    t, _ = _both()
    t.declare_leaf("pop/x.y", partition.Member(model_dim=0))
    with pytest.raises(partition.PartitionMismatchError,
                       match="member axis"):
        t.resolve("pop/x.y", (8, 4), n_data=4)


@pytest.mark.parametrize("path,shape", [
    ("fc1/output", (8, 16)), ("fc1/weights", (12, 16)),
    ("fc2/weights", (12, 16)), ("fc1/n_err", ())])
def test_stage_tags_compose_as_in_the_reference(path, shape):
    t, r = _both()
    t.declare(r"^fc1/", partition.Stage(1))
    r.declare(r"^fc1/", ref_partition.Stage(1))
    _same(t.resolve(path, shape, n_data=4), r.resolve(path, shape, n_data=4))


def test_stage_inner_placement_and_unmatched_error():
    t, r = _both()
    t.declare(r"^fc1/weights$", partition.Stage(2, inner=(None, MODEL_AXIS)))
    r.declare(r"^fc1/weights$",
              ref_partition.Stage(2, inner=P(None, MODEL_AXIS)))
    _same(t.resolve("fc1/weights", (8, 16), n_data=4),
          r.resolve("fc1/weights", (8, 16), n_data=4))
    t.declare(r"^fc3/", partition.Stage(0))
    with pytest.raises(partition.UnmatchedLeafError, match="no rule"):
        t.resolve("fc3/not_a_slot", (4, 4))


@pytest.mark.parametrize("slot", ["output", "err_input", "minibatch_data",
                                  "weights", "bias", "accumulated_"
                                  "gradient_weights", "lr_state"])
def test_default_tail_covers_canonical_slots(slot):
    t, r = _both()
    path = f"fc1/{slot}"
    if slot.startswith("accumulated_"):
        with pytest.raises(partition.UnmatchedLeafError):
            t.resolve(path, (8, 16), n_data=4)
        with pytest.raises(ref_partition.UnmatchedLeafError):
            r.resolve(path, (8, 16), n_data=4)
        return
    _same(t.resolve(path, (8, 16), n_data=4),
          r.resolve(path, (8, 16), n_data=4))


def test_audit_lists_matches_by_section():
    t, r = _both()
    for table, stage in ((t, partition.Stage(0)),
                         (r, ref_partition.Stage(0))):
        table.declare(r"^fc1/", stage)
        table.declare_leaf("fc1/weights", partition.REPLICATED
                           if table is t else ref_partition.REPLICATED)
    assert t.audit("fc1/weights") == r.audit("fc1/weights")


# ----------------------------------------------------------------------
# tensor parallelism, a spawned 2 × 2 world
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    return worker.spawn_world("tp", RANKS, out), out


def test_tp_matches_replicated(tp_world):
    world, _ = tp_world
    rep, tp = world[0]["replicated"], world[0]["tp"]
    for a, b in zip(rep["params"], tp["params"]):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    assert rep["err"] == tp["err"]
    for rank in world[1:]:
        for a, b in zip(tp["params"], rank["tp"]["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arm", ["tp", "tp_zero1"])
def test_tp_clipping_matches_replicated(tp_world, arm):
    """``gradient_clip`` under tensor parallelism, alone and with
    ZeRO-1: each block is clipped by the norm of the whole parameter, so
    the run stays the replicated one's, at :func:`test_tp_matches_
    replicated`'s tolerance."""
    world, _ = tp_world
    got = world[0]["clipped"]
    for a, b in zip(got["replicated"], got[arm]):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-4)
    for rank in world[1:]:
        for a, b in zip(got[arm], rank["clipped"][arm]):
            np.testing.assert_array_equal(a, b)


def test_tp_local_blocks(tp_world):
    """Column weights split n_out and the output is feature-sharded; row
    weights split n_in and the output is whole (the reference's shard
    shapes, per process: 24 rows over 2 data ranks)."""
    world, _ = tp_world
    assert world[0]["tp"]["local"] == {
        "col_weights": (12, 16 // 2), "col_output": (24 // 2, 16 // 2),
        "row_weights": (16 // 2, 12), "row_output": (24 // 2, 12)}
    assert world[0]["replicated"]["local"]["col_weights"] == (12, 16)


def test_tp_placements_come_from_the_table(tp_world):
    world, _ = tp_world
    leaves = world[0]["tp"]["placements"]
    want = {"weights": ((None, MODEL_AXIS), 1), "bias": ((MODEL_AXIS,), 0)}
    col = {k.split("/")[1]: v for k, v in leaves.items()
           if k.startswith(next(iter(leaves)).split("/")[0] + "/")}
    assert col == want
    assert ((MODEL_AXIS, None), 0) in leaves.values()


def test_tp_rules_arm_equals_the_legacy_arm(tp_world):
    """``engine.partition_rules = False`` applies the same placements
    directly: the same blocks, the same weights to the bit, and no leaf
    in the table."""
    world, _ = tp_world
    legacy = world[0]["legacy_arm"]
    for a, b in zip(world[0]["tp"]["params"], legacy["params"]):
        np.testing.assert_array_equal(a, b)
    assert sorted(map(repr, legacy["placements"].values())) \
        == sorted(map(repr, world[0]["tp"]["placements"].values()))
    assert legacy["table"] == 0


def test_tp_indivisible_raises(tp_world):
    world, _ = tp_world
    for rank in world:
        assert "divisible" in rank["indivisible"]


def test_tp_export_serves_on_single_device(tp_world):
    """Process 0 wrote both bundles, the TP one gathered from the
    blocks; each serves on one CPU device, with the same predictions."""
    from tests.conftest import make_blobs
    from znicz_tpu_torch.export import ExportedModel
    world, _ = tp_world
    batch = make_blobs(40, 3, 12)[0][:16].astype(np.float32)
    probs = {}
    for arm in ("replicated", "tp"):
        served = ExportedModel.load(world[0][arm]["bundle"], device="cpu")
        probs[arm] = np.asarray(served(batch))
    assert probs["tp"].shape == (16, 3)
    np.testing.assert_allclose(probs["tp"].sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(probs["tp"], probs["replicated"],
                               rtol=5e-3, atol=1e-4)


def test_zero1_dp_tp_compose(tp_world):
    """ZeRO-1 over ``data`` with the column/row pair over ``model``: the
    column momentum's data dim is 0 (the model takes dim 1), each
    process stores (12 / 2, 16 / 2)."""
    world, _ = tp_world
    got = world[0]["dp_tp_zero1"]
    assert got["plan"] == (0, 1)
    assert got["acc_local"] == (12 // 2, 16 // 2)
    for a, b in zip(got["replicated"], got["zero1"]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_dp_tp_zero1_snapshot_resumes_on_any_layout(tp_world):
    """The TP + ZeRO-1 snapshot holds the logical shapes (the blocks of
    both axes gathered); loaded back onto the 2 × 2 mesh it goes on bit
    for bit as the run it was taken from, and on one device within
    1e-5."""
    import torch
    from znicz_tpu_torch.backends import CpuDevice
    from znicz_tpu_torch.utils import prng
    world, _ = tp_world
    got = world[0]["dp_tp_zero1"]
    units = got["state"]["__units__"]
    for key in ("weights", "accumulated_gradient_weights"):
        shapes = sorted(tuple(u[key].shape) for u in units.values()
                        if key in u)
        assert shapes == sorted([(12, 16), (16, 8), (8, 3)]), key
    continued, reloaded = got["after"]
    for a, b in zip(continued, reloaded):
        np.testing.assert_array_equal(a, b)
    prng.seed_all(1)
    wf = worker.build_fc(gd_extra={"weights_decay": 0.01}, max_epochs=2,
                         model_parallel=True)
    wf.initialize(device=CpuDevice(torch.device("cpu")))
    wf.load_state(got["state"])
    wf.run()
    for a, b in zip(worker.params(wf), continued):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_seq_parallel_rides_the_model_axis_beside_data(tp_world):
    """On the (data 2, model 2) mesh, with no ``seq`` axis, the
    attention unit's ring rides ``model`` (the reference's rule) while
    the batch splits over ``data``: the classifier trains to the
    parameters of one device (the reference's
    ``test_attention.py::test_seq_parallel_matches_local`` on the
    port)."""
    world, _ = tp_world
    want = worker.ring_unit_step(None)
    for rank in world:
        for a, b in zip(want, rank["ring_on_model_axis"]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
