"""Stochastic units and batch statistics on a sharded mesh, in spawned
gloo worlds of CPU ranks (``tests/torch_parallel_worker.py``), against
one process over the global batch and against the reference's units on
its virtual 4-device data mesh.

- B3's block map (``fused_kernels.BlockMap``): the plain version on
  blocks of rows, of columns and of both equals the slices of one draw
  over the whole tensor, on the route the kernel would take; the
  identity map is today's masks bit for bit.
- C21: the dropout between a column and a row ``All2All`` on a
  ``model`` axis of 2 draws each rank's column block of the one mask
  one process draws for the whole ``(rows, C)`` output.
- Over a data axis of 4: dropout and stochastic pooling (a small conv
  net), a narrow AlexNet (LRN, dropout twice, ZeRO-1), the RBM
  (``mnist_rbm``: ``Binarization``, ``GradientRBM``) and the SOM
  (``kohonen``), each against one process over the global batch: the
  ranks' draws, stacked in rank order, equal the one process's draws
  step by step, bit for bit; the trained tensors within 1e-5 (rtol
  1e-5, atol 1e-6: the folds reorder sums); every rank's tensors and
  seed chains the same.  The narrow AlexNet also over (data 2, model
  2), its first FC column-parallel: the draws assembled by both
  coordinates, the parameters within the tensor-parallel tolerance of
  ``tests/test_torch_parallel.py`` (rtol 1e-3, atol 1e-4).
- The SOM's units and the RBM's (CD-1 from an injected sample,
  ``BatchWeights``), each rank on its rows, against the reference's
  units on ``make_mesh(n_data=4)`` over 4 of its virtual devices at the
  reference's data-parallel tolerance (rtol 1e-3, atol 1e-4).
- The pipe axis: ``make_mesh(n_data=2, n_pipe=2)`` (the port of
  ``tests/test_partition.py:471-490``), a stage's block group and its
  data group, and the fc net trained on a stage's mesh and on the whole
  pipe mesh (the pipe axis unused) as on one process.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from znicz_tpu_torch.backends import CpuDevice
from znicz_tpu_torch.ops import fused_kernels as fk
from znicz_tpu_torch.ops.fused_kernels import BlockMap
from znicz_tpu_torch.utils.config import reset_root

RANKS = 4
#: data parallelism against one process (the fold reorders sums)
DP_TOL = dict(rtol=1e-5, atol=1e-6)
#: against the reference's mesh, and tensor parallelism against one
#: process (the reference's)
REF_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


@pytest.fixture(scope="module")
def c21_world(tmp_path_factory):
    return worker.spawn_world("c21", 2, tmp_path_factory.mktemp("c21"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.spawn_world("stochastic", RANKS,
                              tmp_path_factory.mktemp("stochastic"))


def one_process(name):
    reset_root()
    return worker.stochastic_arm(name, CpuDevice(torch.device("cpu")))


# ----------------------------------------------------------------------
# B3's block map, the plain version
# ----------------------------------------------------------------------
ROWS, COLS, SEED = 12, 48, 20261018


@pytest.mark.parametrize("layout,blocks,route", [
    ("rows", [(slice(3 * k, 3 * k + 3), slice(None)) for k in range(4)],
     "vector"),
    ("columns", [(slice(None), slice(24 * k, 24 * k + 24))
                 for k in range(2)], "vector"),
    ("grid", [(slice(6 * i, 6 * i + 6), slice(24 * j, 24 * j + 24))
              for i in range(2) for j in range(2)], "vector"),
    ("uneven_columns", [(slice(None), slice(0, 20)),
                        (slice(None), slice(20, 48))], "general"),
    ("rows_off_8", [(slice(1, 2), slice(None))], "vector"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_map_draws_slices_of_one_draw(layout, blocks, route, dtype):
    """Each block's output, through the plain version with its map, is
    the slice of one draw over the whole ``(12, 48)`` tensor, forward
    and backward alike; the route is the one :func:`dropout_route` gives
    a block so placed (a column offset off 8 takes the general
    kernel)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(ROWS, COLS, generator=gen).to(dtype)
    err = torch.randn(ROWS, COLS, generator=gen).to(dtype)
    y, dx = (fk.dropout_apply_plain(t, SEED, 0.5) for t in (x, err))
    bits = fk.dropout_bits(ROWS * COLS, SEED).view(ROWS, COLS)
    for rs, cs in blocks:
        block = BlockMap(rs.start or 0, cs.start or 0, COLS)
        xb, eb = x[rs, cs].contiguous(), err[rs, cs].contiguous()
        assert torch.equal(fk.dropout_apply(xb, SEED, 0.5, block), y[rs, cs])
        assert torch.equal(fk.dropout_apply_plain(eb, SEED, 0.5, block),
                           dx[rs, cs])
        assert torch.equal(fk.block_bits(*xb.shape, SEED, block=block),
                           bits[rs, cs])
        assert fk.dropout_route(0, 16, cols=xb.shape[1],
                                block=block) == route
    # a 48-wide row from row 1 starts at index 48: a multiple of 8
    assert fk.dropout_route(0, cols=12, block=BlockMap(1, 0, 12)) \
        == "general"


def test_identity_map_is_todays_mask():
    """One process (no map, or the map of a block that is the whole)
    draws element i's bits at index i, as before the map: the masks of
    one device are unchanged bit for bit."""
    x = torch.ones(7, 33)
    want = torch.where(fk.dropout_bits(x.numel(), SEED).view(7, 33)
                       > int(0.25 * (2 ** 32 - 1)), 1.0 / 0.75, 0.0)
    assert torch.equal(fk.dropout_apply_plain(x, SEED, 0.25), want)
    assert torch.equal(fk.dropout_apply(x, SEED, 0.25,
                                        BlockMap(0, 0, 33)), want)
    assert fk.dropout_route(0, 16, cols=33) == "vector"
    from znicz_tpu_torch.ops.nn_units import block_map
    assert block_map(CpuDevice(torch.device("cpu")), x) is None
    with pytest.raises(ValueError, match="cannot hold"):
        fk.dropout_apply(x, SEED, 0.25, BlockMap(0, 3, 33))


# ----------------------------------------------------------------------
# C21
# ----------------------------------------------------------------------
def test_c21_dropout_after_a_column_layer_draws_its_block(c21_world):
    """Each model rank's train-step mask is its column block of the
    mask of the whole ``(24, 16)`` output under the same seed; the two
    ranks draw the same seed (their chains rooted in the same draw)."""
    assert {rank["seed"] for rank in c21_world} == {c21_world[0]["seed"]}
    seed, ratio = c21_world[0]["seed"], c21_world[0]["ratio"]
    rows, block = c21_world[0]["kept"].shape
    whole = (fk.dropout_apply_plain(torch.ones(rows, 2 * block), seed,
                                    ratio) != 0).numpy()
    for rank in c21_world:
        assert rank["minibatch_class"] == 2  # a train step
        assert rank["input_kept"].all()
        r = rank["model_rank"]
        np.testing.assert_array_equal(
            rank["kept"], whole[:, r * block:(r + 1) * block])


# ----------------------------------------------------------------------
# a data axis of 4 against one process
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arm", list(worker.STOCHASTIC_ARMS))
def test_data_axis_matches_one_process(world, arm):
    """The ranks' draws stacked in rank order are one process's draws,
    step by step, bit for bit; the trained tensors within ``DP_TOL``;
    the ranks' tensors bit-equal."""
    single = one_process(arm)
    got = world[0][arm]
    assert set(got["draws"]) == set(single["draws"])
    for key, want in single["draws"].items():
        assert len(want) == len(got["draws"][key]) > 0, key
        for step, whole in enumerate(want):
            stacked = np.concatenate([rank[arm]["draws"][key][step]
                                      for rank in world])
            np.testing.assert_array_equal(stacked, whole,
                                          err_msg=f"{key} step {step}")
    assert set(got["state"]) == set(single["state"])
    for key, want in single["state"].items():
        np.testing.assert_allclose(got["state"][key], want, **DP_TOL,
                                   err_msg=key)
        for rank in world[1:]:
            np.testing.assert_array_equal(rank[arm]["state"][key],
                                          got["state"][key], err_msg=key)


@pytest.mark.parametrize("arm", ["stochastic_conv", "narrow_alexnet",
                                 "mnist_rbm"])
def test_seed_chains_rooted_in_the_same_draw(world, arm):
    """Every process roots each chain in the same draw: each seeds the
    default generator with the run's seed and makes the same draws in
    the same order (the loader's shuffle seed, the weight fills, the
    chains' roots), so after the run each chain holds one process's
    value on every rank."""
    single = one_process(arm)
    assert any(v is not None for v in single["chains"].values())
    for rank in world:
        assert rank[arm]["chains"] == single["chains"]


def test_narrow_alexnet_over_data_and_model(world):
    """(data 2, model 2): the dropout after the column FC draws its
    (rows, columns) block, the one after the row FC its rows (the same
    on both model ranks); the parameters within ``REF_TOL`` of one
    process."""
    single = one_process("narrow_alexnet")
    ranks = {tuple(rank["narrow_alexnet_tp"]["coords"]):
             rank["narrow_alexnet_tp"] for rank in world}
    assert sorted(ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    col_key, row_key = sorted(single["draws"],
                              key=lambda k: int(k.split(".")[0]))
    for step, whole in enumerate(single["draws"][col_key]):
        got = np.concatenate([np.concatenate(
            [ranks[d, m]["draws"][col_key][step] for m in range(2)], axis=1)
            for d in range(2)])
        np.testing.assert_array_equal(got, whole)
    for step, whole in enumerate(single["draws"][row_key]):
        for m in range(2):
            got = np.concatenate([ranks[d, m]["draws"][row_key][step]
                                  for d in range(2)])
            np.testing.assert_array_equal(got, whole)
    reset_root()
    from znicz_tpu_torch.utils import prng
    prng.seed_all(worker.STOCHASTIC_SEED)
    wf = worker.build_narrow_alexnet()
    worker.train_steps(wf, CpuDevice(torch.device("cpu")))
    for a, b in zip(worker.params(wf), ranks[0, 0]["params"]):
        np.testing.assert_allclose(b, a, **REF_TOL)


# ----------------------------------------------------------------------
# the SOM's and the RBM's units against the reference's data mesh
# ----------------------------------------------------------------------
def _ref_mesh_device():
    from znicz_tpu.backends import XLADevice
    from znicz_tpu.parallel import make_mesh
    return XLADevice(mesh=make_mesh(n_data=RANKS,
                                    devices=jax.devices()[:RANKS]))


def _read(vec):
    vec.map_read()
    return np.array(vec.mem, copy=True)


def test_som_units_match_the_reference_mesh(world):
    from znicz_tpu.dummy import DummyUnit, DummyWorkflow
    from znicz_tpu.memory import Vector
    from znicz_tpu.ops import kohonen as ref_ops
    inp = worker.som_rbm_inputs()
    dev = _ref_mesh_device()
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(inp["som_x"].copy(), name="x"))
    fwd = ref_ops.KohonenForward(wf, shape=worker.SOM_GRID)
    fwd.link_attrs(src, ("input", "output"))
    fwd.weights.reset(inp["som_w"].copy())
    fwd.initialize(device=dev)
    tr = ref_ops.KohonenTrainer(wf, learning_rate=0.4, decay_steps=50)
    tr.link_attrs(src, ("input", "output"))
    tr.link_attrs(fwd, "weights", "winners")
    tr.shape_grid = worker.SOM_GRID
    tr.initialize(device=dev)
    for _ in range(3):
        fwd.run()
        tr.run()
    got = [rank["units"]["som"] for rank in world]
    np.testing.assert_array_equal(
        np.concatenate([g["winners"] for g in got]), _read(fwd.winners))
    for g in got:
        np.testing.assert_array_equal(g["hits"], _read(fwd.hits))
        np.testing.assert_allclose(g["weights"], _read(fwd.weights),
                                   **REF_TOL)
        assert g["time"] == 3.0
        np.testing.assert_array_equal(g["weights"], got[0]["weights"])


def test_rbm_units_match_the_reference_mesh(world):
    """CD-1 from an injected sample (deterministic) with momentum over
    two steps, and ``BatchWeights`` on the updated chain's data, each
    rank on its rows against the reference's units on its mesh."""
    from znicz_tpu.dummy import DummyUnit, DummyWorkflow
    from znicz_tpu.memory import Vector
    from znicz_tpu.ops import rbm_units as ref_rbm
    inp = worker.som_rbm_inputs()
    dev = _ref_mesh_device()
    wf = DummyWorkflow()
    unit = ref_rbm.GradientRBM(wf, learning_rate=0.1, gradient_moment=0.9)
    for attr, key in (("input", "v0"), ("hidden", "h0"),
                      ("hidden_sample", "s0")):
        unit.link_attrs(DummyUnit(wf, output=Vector(inp[key].copy(),
                                                    name=key)),
                        (attr, "output"))
    unit.link_attrs(DummyUnit(wf, w=Vector(inp["w"].copy(), name="w"),
                              b=Vector(inp["hb"].copy(), name="hb")),
                    ("weights", "w"), ("hbias", "b"))
    unit.vbias.reset(inp["vb"].copy())
    unit.initialize(device=dev)
    bw = ref_rbm.BatchWeights(wf)
    bw.link_attrs(DummyUnit(wf, output=Vector(inp["v0"].copy(), name="v")),
                  ("v", "output"))
    bw.link_attrs(DummyUnit(wf, output=Vector(inp["h0"].copy(), name="h")),
                  ("h", "output"))
    bw.initialize(device=dev)
    for _ in range(2):
        unit.run()
    bw.run()
    got = [rank["units"] for rank in world]
    np.testing.assert_allclose(
        np.concatenate([g["rbm"]["reconstruction"] for g in got]),
        _read(unit.reconstruction), **REF_TOL)
    for g in got:
        for name in ("weights", "hbias", "vbias"):
            np.testing.assert_allclose(g["rbm"][name],
                                       _read(getattr(unit, name)),
                                       **REF_TOL, err_msg=name)
        for a, vec in zip(g["batch_weights"],
                          (bw.weights_batch, bw.v_mean, bw.h_mean)):
            np.testing.assert_allclose(a, _read(vec), **REF_TOL)


# ----------------------------------------------------------------------
# the pipe axis
# ----------------------------------------------------------------------
def test_pipe_axis_mesh_and_its_stages(world):
    """The leading ``pipe`` axis (the reference's shape and names), each
    stage a contiguous block of ranks with its own group, and
    ``mesh_for_stage`` of a pipe-less mesh the mesh itself; the fc net
    trained on a stage's mesh and on the whole pipe mesh (its pipe axis
    unused: each stage trains alike) as on one process."""
    from znicz_tpu_torch.parallel.axis import (DATA_AXIS, MODEL_AXIS,
                                               PIPE_AXIS)
    single = worker.params(worker_single_fc())
    for rank, got in enumerate(world):
        pipe = got["pipe"]
        assert pipe["axis_names"][0] == PIPE_AXIS
        assert pipe["shape"] == {PIPE_AXIS: 2, DATA_AXIS: 2, MODEL_AXIS: 1}
        assert pipe["coords"][PIPE_AXIS] == rank // 2
        for k, (names, shape, ranks, member) in enumerate(pipe["stages"]):
            assert PIPE_AXIS not in names
            assert shape == {DATA_AXIS: 2, MODEL_AXIS: 1}
            assert ranks == [2 * k, 2 * k + 1]
            assert member == (k == rank // 2)
        assert pipe["plain_is_identity"]
        assert pipe["block_sum"] == pipe["data_sum"] \
            == sum(range(2 * (rank // 2), 2 * (rank // 2) + 2))
        for a, b, c in zip(single, pipe["stage_params"],
                           pipe["pipe_params"]):
            np.testing.assert_allclose(b, a, **DP_TOL)
            np.testing.assert_array_equal(c, b)


def worker_single_fc():
    from znicz_tpu_torch.utils import prng
    from znicz_tpu_torch.utils.config import root
    root.common.engine.zero1 = "auto"
    prng.seed_all(1234)
    wf = worker.build_fc(hidden2=None)
    wf.initialize(device=CpuDevice(torch.device("cpu")))
    wf.run()
    return wf
