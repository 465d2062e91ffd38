"""The port's population engine (``znicz_tpu_torch.population``) on the
CPU: the cases of ``tests/test_population.py`` through the port, held to
the reference where the two can meet.

- the K-member step is K sequential runs bit for bit (weights, bias and
  momentum after 3 epochs, dropout's seed chains and each member's
  epoch order included), and the fitness is each run's decision's;
- ``install_best``, evolution replayed from one seed, PBT's exploit a
  bitwise copy, GA keeping its elite, the telemetry series, the
  published best member promoted into a serving engine;
- the member axis over a 4-rank gloo world (a ``file://`` store): K = 8
  is two members a rank, K = 6 stays whole on every rank; PBT over the
  spread axis equals PBT in one process;
- the genetics mesh backend and the stacked ensemble;
- against the reference: the stacked initial leaves, the epoch orders
  and ``truncation_count`` bit for bit; K = 3 with dropout off after 2
  epochs within 1e-5 of each tensor's largest |value| (f32 sums in
  another order, as ``tests/test_torch_mlp.py``), the fitness equal;
  the PBT and GA applies, fed the reference's draws, bit-equal to the
  reference's step; ``promote_lr_leaves`` steps bit-equal to the
  float-rate steps;
- the graphs with a stand-in for the CUDA graph API: one capture a key,
  none after a generation, a rebound shared tensor or stacked buffer
  refused.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import make_blobs
from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
from znicz_tpu.models.standard_workflow import StandardWorkflow as RefWorkflow
from znicz_tpu.population import PopulationTrainer as RefTrainer
from znicz_tpu.population import evolution as ref_evo
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch.accelerated_units import CAPTURE_LOCK
from znicz_tpu_torch.loader.base import VALID
from znicz_tpu_torch.loader.fullbatch import ArrayLoader
from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.parallel import partition
from znicz_tpu_torch.population import (PopulationRegion, PopulationTrainer,
                                        evolution, harvest_state,
                                        leaf_keys)
from znicz_tpu_torch.population.engine import MEMBER_ALIGN
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA, LABELS = make_blobs(24, 3, 10, seed=7)
TOL = 1e-5


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _layers(learning_rate, dropout):
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
               "<-": {"learning_rate": learning_rate,
                      "gradient_moment": 0.9}}]
    if dropout:
        layers.append({"type": "dropout", "->": {"dropout_ratio": 0.25}})
    layers.append({"type": "softmax", "->": {"output_sample_shape": 3},
                   "<-": {"learning_rate": learning_rate,
                          "gradient_moment": 0.9}})
    return layers


def build(learning_rate=0.05, max_epochs=3, dropout=True, **kw):
    """The reference test's net, in the port."""
    return StandardWorkflow(
        name="pop_net",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=DATA[:48], train_labels=LABELS[:48],
            valid_data=DATA[48:], valid_labels=LABELS[48:],
            minibatch_size=12),
        layers=_layers(learning_rate, dropout),
        decision_config={"max_epochs": max_epochs})


def ref_build(learning_rate=0.05, max_epochs=3, dropout=True, **kw):
    return RefWorkflow(
        name="pop_net",
        loader_factory=lambda w: RefLoader(
            w, train_data=DATA[:48], train_labels=LABELS[:48],
            valid_data=DATA[48:], valid_labels=LABELS[48:],
            minibatch_size=12),
        layers=_layers(learning_rate, dropout),
        decision_config={"max_epochs": max_epochs})


def _param_tensors(wf):
    """Weights, bias and both momenta of every weighted layer."""
    out = []
    for fwd, gd_unit in zip(wf.forwards, wf.gds):
        for t in (getattr(fwd, "weights", None), getattr(fwd, "bias", None),
                  getattr(gd_unit, "accumulated_gradient_weights", None),
                  getattr(gd_unit, "accumulated_gradient_bias", None)):
            if isinstance(t, torch.Tensor):
                out.append(t)
    return out


def _ref_param_vectors(wf):
    out = []
    for fwd, gd_unit in zip(wf.forwards, wf.gds):
        for vec in (fwd.weights, fwd.bias,
                    gd_unit.accumulated_gradient_weights,
                    gd_unit.accumulated_gradient_bias):
            if vec is not None and vec:
                out.append(vec)
    return out


def _trainer(k, base_seed, **kw):
    kw.setdefault("device", "cpu")
    return PopulationTrainer(build, k, base_seed=base_seed, **kw)


# ----------------------------------------------------------------------
# the cases of tests/test_population.py
# ----------------------------------------------------------------------
def test_population_step_bitwise_equals_sequential_runs():
    """Member i after 3 epochs is its sequential run bit for bit
    (weights, bias, momentum; dropout's chains and the epoch orders
    included), and its fitness the run's decision's best."""
    k = 3
    oracle = []
    for i in range(k):
        prng.seed_all(500 + i)
        wf = build()
        wf._max_fires = 10 ** 6
        wf.initialize(device="cpu")
        wf.run()
        oracle.append(([t.detach().clone().numpy()
                        for t in _param_tensors(wf)],
                       -wf.decision.min_validation_n_err_pt))
    trainer = _trainer(k, 500, evolve=None, name="pop_bitwise")
    trainer.initialize()
    trainer.run(3)
    for i in range(k):
        want_params, want_fit = oracle[i]
        for t, want in zip(_param_tensors(trainer.template), want_params):
            got = trainer.region.read_leaf(t)[i]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert trainer.member_best_fitness[i] == pytest.approx(want_fit)


def _lm_build(learning_rate=0.08, max_epochs=2, **kw):
    """A small causal-LM drafter (embedding → pos_encoding → causal
    attention → last_token → softmax): autograd's backward and the
    shared encoding table inside the member step."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 12, size=(160, 8)).astype(np.float32)
    labels = rng.integers(0, 12, size=160).astype(np.int32)
    lr = {"learning_rate": learning_rate, "gradient_moment": 0.9}
    return StandardWorkflow(
        name="drafter", loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:128], train_labels=labels[:128],
            valid_data=data[128:], valid_labels=labels[128:],
            minibatch_size=32),
        layers=[{"type": "embedding", "->": {"vocab_size": 12, "dim": 8},
                 "<-": lr},
                {"type": "pos_encoding", "->": {}},
                {"type": "attention", "->": {"n_heads": 2, "causal": True},
                 "<-": lr},
                {"type": "last_token", "->": {}},
                {"type": "softmax", "->": {"output_sample_shape": 12},
                 "<-": lr}],
        decision_config={"max_epochs": max_epochs})


def _module_tensors(wf):
    return {f"{u.name}.{n}": t for u in [*wf.forwards, *wf.gds]
            for n, t in [*u._parameters.items(), *u._buffers.items()]
            if isinstance(t, torch.Tensor) and n != "lr_state"}


def test_attention_population_bitwise_equals_sequential_runs():
    oracle = []
    for i in range(2):
        prng.seed_all(40 + i)
        wf = _lm_build()
        wf._max_fires = 10 ** 6
        wf.initialize(device="cpu")
        wf.run()
        oracle.append({k: t.detach().clone().numpy()
                       for k, t in _module_tensors(wf).items()})
    trainer = PopulationTrainer(_lm_build, 2, base_seed=40, evolve=None,
                                device="cpu", name="pop_lm")
    trainer.initialize()
    trainer.run(2)
    region = trainer.region
    tensors = _module_tensors(trainer.template)
    assert tensors
    for key, t in tensors.items():
        assert region.is_member(t), key
        got = region.read_leaf(t)
        for i in range(2):
            np.testing.assert_array_equal(got[i], oracle[i][key])


def test_population_install_best_and_oracle_forward():
    trainer = _trainer(3, 500, evolve=None, name="pop_install")
    trainer.initialize()
    trainer.run(2)
    best = trainer.install_best()
    for t in _param_tensors(trainer.template):
        np.testing.assert_array_equal(t.detach().numpy(),
                                      trainer.region.read_leaf(t)[best])


def test_population_evolution_deterministic_under_fixed_seed():
    runs = []
    for _ in range(2):
        trainer = _trainer(4, 300, evolve="pbt", evolve_every=1,
                           lr_bounds=(0.005, 0.5), seed=11, name="pop_det")
        trainer.initialize()
        trainer.run(3)
        w = trainer.region.read_leaf(trainer.template.forwards[0].weights)
        runs.append((trainer.history, trainer.region.member_lrs(),
                     np.array(w, copy=True)))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


def test_pbt_exploit_copies_winner_bitwise_and_explores_lr():
    k = 4
    trainer = _trainer(k, 400, evolve="pbt", truncation=0.25, seed=21,
                       name="pop_exploit")
    trainer.initialize()
    trainer.run_epoch()
    region = trainer.region
    watch = _param_tensors(trainer.template)
    before = [np.array(region.read_leaf(t), copy=True) for t in watch]
    lrs_before = region.member_lrs()
    # member 3 the loser, member 0 the only winner (so the donor)
    trainer.evolve_generation(np.array([3.0, 2.0, 1.0, 0.0]))
    for t, was in zip(watch, before):
        after = region.read_leaf(t)
        np.testing.assert_array_equal(after[3], was[0])
        for member in (0, 1, 2):
            np.testing.assert_array_equal(after[member], was[member])
    lrs_after = region.member_lrs()
    ratio = lrs_after[3] / lrs_before[0]
    assert min(abs(ratio - 0.8), abs(ratio - 1.25)) < 1e-6, ratio
    np.testing.assert_array_equal(lrs_after[:3], lrs_before[:3])


def test_member_placement_follows_the_member_rule():
    """The placement the member axis takes (``partition.Member``): dim 0
    over the data axis when K divides it, whole otherwise; a member's
    model dim cannot be dim 0."""
    spread = partition.materialize(partition.Member(), "w", (8, 10, 16), 4)
    assert spread.member_axis and spread.spec[0] == "data"
    whole = partition.materialize(partition.Member(), "w", (6, 10, 16), 4)
    assert whole.spec[0] is None
    with pytest.raises(partition.PartitionMismatchError,
                       match="member axis"):
        partition.materialize(partition.Member(model_dim=0), "w",
                              (8, 10), 4)


def test_population_telemetry_series_registered():
    trainer = _trainer(3, 700, evolve="pbt", evolve_every=1, seed=5,
                       name="pop_obs")
    trainer.initialize()
    trainer.run(2)
    fit = metrics.REGISTRY.get("znicz_population_fitness")
    members = {key[1] for key, _ in fit.items() if key[0] == "pop_obs"}
    assert members == {"0", "1", "2"}
    assert metrics.population_members("pop_obs").value == 3
    assert metrics.population_generations("pop_obs").value == 1
    assert metrics.population_evolution("pop_obs", "exploit").value >= 1
    assert metrics.population_evolution("pop_obs", "explore").value >= 1
    assert metrics.population_best_fitness("pop_obs").value == \
        pytest.approx(trainer.best_fitness)


def test_population_ga_strategy_runs_and_keeps_elite():
    trainer = _trainer(4, 900, evolve="ga", evolve_every=1, elite=1,
                       lr_bounds=(0.005, 0.5), seed=2, name="pop_ga")
    trainer.initialize()
    trainer.run_epoch()
    region = trainer.region
    w = trainer.template.forwards[0].weights
    before = np.array(region.read_leaf(w), copy=True)
    trainer.evolve_generation(np.array([0.0, 5.0, 1.0, 2.0]))
    after = region.read_leaf(w)
    np.testing.assert_array_equal(after[1], before[1])
    assert metrics.population_evolution("pop_ga", "crossover").value == 3
    lrs = region.member_lrs()
    assert np.all(lrs >= 0.005) and np.all(lrs <= 0.5)


def test_population_publish_best_feeds_canary_pipeline(tmp_path):
    """publish_best writes a bundle with its digest sidecar, which the
    watcher verifies and a SwapController promotes into a live
    engine."""
    from znicz_tpu_torch.export import ExportedModel
    from znicz_tpu_torch.resilience.publisher import (PublicationWatcher,
                                                      SwapController,
                                                      classifier_score)
    from znicz_tpu_torch.serving import ServingEngine

    trainer = _trainer(3, 950, evolve=None, name="pop_publish")
    trainer.initialize()
    trainer.run(2)
    pubdir = str(tmp_path / "published")
    version, path = trainer.publish_best(pubdir)
    assert version == 1
    watcher = PublicationWatcher(pubdir)
    got = watcher.poll()
    assert got is not None and got[0] == 1
    oracle = ExportedModel.load(path, device="numpy")
    assert np.asarray(oracle(DATA[48:52])).shape == (4, 3)
    with ServingEngine(path, max_batch=4, max_delay_ms=2.0,
                       device="cpu") as engine:
        engine.set_model_version(1)
        controller = SwapController(
            engine, watcher, classifier_score(DATA[48:], LABELS[48:]),
            guard_margin=0.5, probation_steps=1)
        version2, _ = trainer.publish_best(pubdir)
        assert version2 == 2
        events = controller.tick()
        assert any("promoted" in e for e in events), events
        assert engine.model_version == 2


def test_genetics_mesh_backend_matches_process_fitness():
    from znicz_tpu_torch.genetics import GeneticsOptimizer, Tune

    genomes = [{"learning_rate": v} for v in (0.02, 0.1, 0.3)]
    space = {"learning_rate": Tune(0.05, 0.01, 0.4)}
    proc = GeneticsOptimizer(
        build_fn=build, space=space, population_size=3, generations=1,
        seed=9, device_factory=lambda: "cpu",
        train_kwargs={"max_epochs": 2})
    want = [proc._train_fitness(dict(g)) for g in genomes]
    mesh = GeneticsOptimizer(
        build_fn=build, space=space, population_size=3, generations=1,
        seed=9, backend="mesh", device_factory=lambda: "cpu",
        train_kwargs={"max_epochs": 2})
    pending = [(tuple(sorted(g.items())), g) for g in genomes]
    mesh._score_population_mesh(pending)
    assert [mesh._cache[k] for k, _ in pending] == want
    assert mesh.local_evaluated == [k for k, _ in pending]


def test_genetics_mesh_backend_full_run():
    from znicz_tpu_torch.genetics import GeneticsOptimizer, Tune

    opt = GeneticsOptimizer(
        build_fn=build, space={"learning_rate": Tune(0.05, 0.01, 0.4)},
        population_size=4, generations=2, seed=3, backend="mesh",
        device_factory=lambda: "cpu", train_kwargs={"max_epochs": 2})
    best = opt.run()
    assert 0.01 <= best["learning_rate"] <= 0.4
    assert len(opt.history) == 2
    assert opt.best_fitness >= opt.history[0]["mean"]


def test_genetics_mesh_backend_rejects_architecture_genomes():
    from znicz_tpu_torch.genetics import GeneticsOptimizer, Tune

    with pytest.raises(ValueError, match="learning_rate"):
        GeneticsOptimizer(build_fn=build, backend="mesh",
                          space={"hidden": Tune(8, 4, 32)})
    with pytest.raises(ValueError, match="learning_rate"):
        GeneticsOptimizer(
            build_fn=build, backend="mesh",
            space={"learning_rate": Tune(0.05, 0.01, 0.4),
                   "wine.layers": Tune(8, 4, 32)})


def test_ensemble_stacked_matches_sequential():
    from znicz_tpu_torch.ensemble import Ensemble

    seq = Ensemble(build, n_models=3, base_seed=42,
                   device_factory=lambda: "cpu",
                   train_kwargs={"max_epochs": 2})
    seq.train()
    want = seq.evaluate(VALID)
    stacked = Ensemble(build, n_models=3, base_seed=42, backend="mesh",
                       device_factory=lambda: "cpu",
                       train_kwargs={"max_epochs": 2})
    stacked.train()
    got = stacked.evaluate(VALID)
    assert got["n_samples"] == want["n_samples"]
    assert got["member_err_pt"] == want["member_err_pt"]
    assert got["ensemble_err_pt"] == want["ensemble_err_pt"]
    assert [s["validation_err_pt"] for s in stacked.member_stats] == \
        [s.get("validation_err_pt") for s in seq.member_stats]


# ----------------------------------------------------------------------
# the port's own contract
# ----------------------------------------------------------------------
def test_member_views_are_aligned_and_keys_stable():
    """Every member's view of a stacked tensor starts on a 512-byte
    boundary, and two builds of one layers list give one key set."""
    trainer = _trainer(3, 10, evolve=None, name="pop_align")
    trainer.initialize()
    region = trainer.region
    stacked = [leaf for leaf in region.leaves if leaf.member]
    assert stacked
    for leaf in stacked:
        for view in leaf.views:
            assert view.data_ptr() % MEMBER_ALIGN == 0, leaf.label
            assert view.is_contiguous()
    other = build()
    other.initialize(device="cpu")
    other.promote_lr_leaves()
    harvested = harvest_state(other)["tensors"]
    assert {leaf.key for leaf in region.leaves} <= set(harvested)
    assert set(harvested) <= set(leaf_keys(
        other._region_unit.region.units).values())
    # the dataset is shared, the schedule's order and cursor are not
    loader = trainer.template.loader
    assert not region.is_member(loader.original_data)
    assert region.is_member(loader.sched_perm)
    assert region.is_member(loader.sched_cursor)


def test_population_needs_a_region_and_a_device():
    trainer = _trainer(2, 1, evolve=None, device="numpy", name="pop_np")
    with pytest.raises(ValueError, match="numpy oracle"):
        trainer.initialize()
    if not torch.cuda.is_available():
        card = PopulationTrainer(build, 2, base_seed=1, evolve=None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            card.initialize()
    with pytest.raises(NotImplementedError, match="debug_checks"):
        from znicz_tpu_torch.utils.config import root
        trainer = _trainer(2, 1, evolve=None, name="pop_checks")
        trainer.initialize()
        root.common.engine.debug_checks = True
        trainer.region.step()


def test_promoted_lr_steps_equal_float_rate_steps():
    """``promote_lr_leaves`` makes the rates device state, [lr, lr_bias]
    in f32; the steps after it are bit for bit the float-rate steps, and
    a second call (or a schedule's own lr_state) changes nothing."""
    runs = []
    for promote in (False, True):
        prng.seed_all(77)
        wf = build(learning_rate=0.0731, max_epochs=2)
        wf._max_fires = 10 ** 6
        wf.initialize(device="cpu")
        if promote:
            wf.promote_lr_leaves()
            states = [g.lr_state for g in wf.gds]
            wf.promote_lr_leaves()
            assert all(g.lr_state is t for g, t in zip(wf.gds, states))
            for g in wf.gds:
                if g.lr_state is not None:
                    assert g.lr_state.dtype == torch.float32
                    np.testing.assert_array_equal(
                        g.lr_state.numpy(), np.float32([0.0731, 0.0731]))
            assert all(g.lr_state is not None for g in wf.gds
                       if isinstance(getattr(g.forward_unit, "weights",
                                             None), torch.Tensor))
        else:
            assert all(g.lr_state is None for g in wf.gds)
        wf.run()
        runs.append([t.detach().clone().numpy()
                     for t in _param_tensors(wf)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------
def test_initial_leaves_orders_and_truncation_equal_the_reference():
    k = 3
    ref = RefTrainer(ref_build, k, base_seed=640, evolve=None,
                     name="ref_init")
    ref.initialize()
    port = _trainer(k, 640, evolve=None, name="port_init")
    port.initialize()
    for t, vec in zip(_param_tensors(port.template),
                      _ref_param_vectors(ref.template)):
        np.testing.assert_array_equal(port.region.read_leaf(t),
                                      np.asarray(ref.region.read_leaf(vec)))
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(
            port.region.stacked_epoch_orders(epoch),
            ref.region.stacked_epoch_orders(epoch).astype(np.int64))
    for n in range(1, 17):
        for trunc in (0.1, 0.25, 0.5, 0.9):
            assert evolution.truncation_count(n, trunc) == \
                ref_evo.truncation_count(n, trunc)


def test_population_matches_the_reference_population():
    """K = 3, dropout off, no evolution, 2 epochs: every member's
    parameters within ``TOL`` of the reference population's, the fitness
    equal."""
    k = 3
    ref_prng.seed_all(1234)
    ref = RefTrainer(ref_build, k, base_seed=820, evolve=None,
                     build_kwargs={"dropout": False}, name="ref_pop")
    ref.initialize()
    ref.run(2)
    port = _trainer(k, 820, evolve=None, build_kwargs={"dropout": False},
                    name="port_pop")
    port.initialize()
    port.run(2)
    for t, vec in zip(_param_tensors(port.template),
                      _ref_param_vectors(ref.template)):
        want = np.asarray(ref.region.read_leaf(vec))
        got = port.region.read_leaf(t)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
    np.testing.assert_array_equal(port.member_best_fitness,
                                  ref.member_best_fitness)
    assert [h["fitness"] for h in port.history] == \
        [h["fitness"] for h in ref.history]


def _ref_leaves(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(5, 4, 3)).astype(np.float32),
            rng.integers(-9, 9, size=(5, 7)).astype(np.int32),
            rng.uniform(0.01, 0.3, size=(5, 2)).astype(np.float32),
            rng.normal(size=(5,)).astype(np.float32)]


@pytest.mark.parametrize("fitness", [
    [0.5, -1.0, 2.0, 2.0, -3.0],     # a tie among the best
    [1.0, 1.0, 1.0, 1.0, 1.0],       # all tied: member order decides
])
def test_pbt_apply_fed_the_reference_draws_equals_its_step(fitness):
    import jax
    import jax.numpy as jnp
    k, lr_slots, bounds = 5, [2], (0.02, 0.25)
    fitness = np.asarray(fitness, np.float32)
    fn, n_cut = ref_evo.build_pbt_step(k, lr_slots, truncation=0.4,
                                       lr_bounds=bounds)
    key = jax.random.fold_in(jax.random.key(31), 2)
    leaves = _ref_leaves(5)
    want = [np.asarray(x) for x in fn(jnp.asarray(fitness), key,
                                      *map(jnp.asarray, leaves))]
    # the reference's draws, computed from the key as its fn does
    order = jnp.argsort(-jnp.asarray(fitness))
    winners, losers = order[:n_cut], order[k - n_cut:]
    kd, kf = jax.random.split(key)
    donors = winners[jax.random.randint(kd, (n_cut,), 0, n_cut)]
    src = jnp.arange(k).at[losers].set(donors)
    explored = jnp.zeros((k,), bool).at[losers].set(True)
    fac = jnp.where(jax.random.bernoulli(kf, 0.5, (k,)), jnp.float32(1.25),
                    jnp.float32(0.8))
    np.testing.assert_array_equal(evolution.ranking(fitness),
                                  np.asarray(order))
    draws = evolution.PBTDraws(
        torch.from_numpy(np.asarray(src).astype(np.int64)),
        torch.from_numpy(np.array(explored)),
        torch.from_numpy(np.array(fac)))
    got = [torch.from_numpy(x.copy()) for x in leaves]
    ptrs = [t.data_ptr() for t in got]
    evolution.apply_pbt(got, draws, lr_slots, bounds)
    assert [t.data_ptr() for t in got] == ptrs  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_ga_apply_fed_the_reference_draws_equals_its_step():
    import jax
    import jax.numpy as jnp
    k, lr_slots, bounds, sigma = 5, [2], (0.02, 0.25), 0.3
    fitness = jnp.asarray([0.5, -1.0, 2.0, 2.0, -3.0], jnp.float32)
    blendable = [True, False, True, True]
    fn, n_elite = ref_evo.build_ga_step(k, blendable, lr_slots, elite=2,
                                        mutation_sigma=sigma,
                                        lr_bounds=bounds)
    key = jax.random.key(8)
    leaves = _ref_leaves(6)
    want = [np.asarray(x) for x in fn(fitness, key,
                                      *map(jnp.asarray, leaves))]
    order = jnp.argsort(-fitness)
    keep = jnp.zeros((k,), bool).at[order[:n_elite]].set(True)
    ka, kb, kw, km = jax.random.split(key, 4)
    src_a = ref_evo.tournament(ka, fitness, k)
    src_b = ref_evo.tournament(kb, fitness, k)
    beta = jax.random.uniform(kw, (k,), dtype=jnp.float32)
    noise = jnp.exp(sigma * jax.random.normal(km, (k,), dtype=jnp.float32))
    draws = evolution.GADraws(*(torch.from_numpy(np.array(x)) for x in (
        keep, np.asarray(src_a).astype(np.int64),
        np.asarray(src_b).astype(np.int64), beta, noise)))
    got = [torch.from_numpy(x.copy()) for x in leaves]
    evolution.apply_ga(got, draws, blendable, lr_slots, bounds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_draws_follow_the_seed_and_the_ranking():
    """The port's own draws: one ``(seed, generation)`` gives one draw;
    PBT's losers are the worst members, each taking a top member's row;
    GA's elite is the best."""
    fit = np.array([0.1, 0.9, 0.5, 0.3, 0.7, 0.2])
    a = evolution.draw_pbt(fit, evolution.generation_generator(4, 1, "cpu"),
                           2)
    b = evolution.draw_pbt(fit, evolution.generation_generator(4, 1, "cpu"),
                           2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    explored = set(np.flatnonzero(a.explored.numpy()))
    assert explored == {0, 5}
    assert set(a.src.numpy()[[0, 5]]) <= {1, 4}
    g = evolution.draw_ga(fit, evolution.generation_generator(4, 2, "cpu"),
                          1)
    assert np.flatnonzero(g.keep.numpy()).tolist() == [1]


# ----------------------------------------------------------------------
# the graphs (a stand-in for the CUDA graph API)
# ----------------------------------------------------------------------
@pytest.fixture
def graph_stand_in(monkeypatch):
    """A capture runs the members (so the step is done, as the warm-up
    before it would have done it) only once, checking CAPTURE_LOCK; a
    replay runs the recorded eager step."""
    replays, locked = [], []

    class Graph:
        def replay(self):
            replays.append(self)

    class Stream:
        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capturing(graph):
        locked.append(CAPTURE_LOCK.locked())
        yield

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", capturing)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(PopulationRegion, "graphed",
                        property(lambda self: True))
    return replays, locked


def test_one_capture_a_key_and_none_after_a_generation(graph_stand_in):
    replays, locked = graph_stand_in
    trainer = _trainer(4, 800, evolve="pbt", evolve_every=1, seed=9,
                       name="pop_graphs")
    trainer.initialize()
    captures = metrics.graph_captures("population:pop_graphs")
    base = captures.value
    trainer.run_epoch()  # validation and train keys
    region = trainer.region
    assert region.captures == 2 and captures.value - base == 2
    assert locked == [True, True]
    assert not CAPTURE_LOCK.locked()
    del replays[:]
    for _ in range(8):  # every key seen: replays only
        region.step()
    trainer.evolve_generation(np.zeros(4))
    region.step()
    assert region.captures == 2 and captures.value - base == 2
    assert len(replays) == 9


def test_a_rebound_tensor_is_refused_by_the_next_replay(graph_stand_in):
    trainer = _trainer(3, 810, evolve=None, name="pop_rebind")
    trainer.initialize()
    trainer.run_epoch()
    loader = trainer.template.loader
    region = trainer.region
    loader.original_data = loader.original_data.clone()
    with pytest.raises(RuntimeError, match="original_data was rebound"):
        region.step()
    trainer2 = _trainer(3, 811, evolve=None, name="pop_rebind2")
    trainer2.initialize()
    trainer2.run_epoch()
    leaf = next(lf for lf in trainer2.region.leaves if lf.member)
    leaf.flat = leaf.flat.clone()
    with pytest.raises(RuntimeError, match="stacked .* was rebound"):
        trainer2.region.step()


# ----------------------------------------------------------------------
# the member axis over a 4-rank gloo world
# ----------------------------------------------------------------------
WORKER = textwrap.dedent('''
    import os, pickle, sys, traceback
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from znicz_tpu_torch.parallel import distributed
    from znicz_tpu_torch.parallel.mesh import make_mesh
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.population import PopulationTrainer

    rng = np.random.default_rng(7)
    centers = rng.normal(0.0, 1.0, size=(3, 10))
    data = np.concatenate([centers[c] + 0.35 * rng.normal(size=(24, 10))
                           for c in range(3)]).astype(np.float32)
    labels = np.repeat(np.arange(3), 24).astype(np.int32)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]

    def build(**kw):
        layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
                   "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                  {"type": "dropout", "->": {"dropout_ratio": 0.25}},
                  {"type": "softmax", "->": {"output_sample_shape": 3},
                   "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]
        return StandardWorkflow(
            name="pop_net", loader_factory=lambda w: ArrayLoader(
                w, train_data=data[:48], train_labels=labels[:48],
                valid_data=data[48:], valid_labels=labels[48:],
                minibatch_size=12),
            layers=layers, decision_config={"max_epochs": 2})

    try:
        distributed.ensure_initialized(
            num_processes=world, process_id=rank, device_type="cpu",
            init_method=f"file://{store}")
        mesh = make_mesh(n_data=world, device_type="cpu")
        result = {}
        for k in (8, 6):
            tr = PopulationTrainer(build, k, base_seed=600, evolve="pbt",
                                   evolve_every=1, seed=13, mesh=mesh,
                                   name=f"pop_shard{k}")
            tr.initialize()
            w = tr.template.forwards[0].weights
            local_rows = tr.region.svec(w).shape[0]
            tr.run(2)
            result[k] = {"members": tr.region.members,
                         "local_rows": local_rows,
                         "history": tr.history,
                         "weights": tr.region.gather_leaf(w),
                         "lrs": tr.region.member_lrs()}
        result = {"ok": True, "result": result}
    except Exception:
        result = {"ok": False, "error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)
    distributed.shutdown()
''')


@pytest.fixture(scope="module")
def shard_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pop_world")
    world = 4
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    script = tmp / "worker.py"
    script.write_text(WORKER)
    store = str(tmp / "store")
    outs = [str(tmp / f"out{r}.pkl") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), store, outs[r]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for r in range(world):
        if not os.path.exists(outs[r]):
            raise RuntimeError(f"rank {r} wrote no result:\n"
                               f"{logs[r][-4000:]}")
        with open(outs[r], "rb") as f:
            got = pickle.load(f)
        if not got["ok"]:
            raise RuntimeError(f"rank {r} failed:\n{got['error']}")
        results.append(got["result"])
    return results


def test_member_axis_spreads_over_the_data_axis(shard_world):
    """K = 8 over 4 ranks: two members a rank, in rank order; K = 6 does
    not divide 4 and stays whole on every rank.  Every rank's history is
    all K members', the same on every rank."""
    for rank, res in enumerate(shard_world):
        assert res[8]["members"] == [2 * rank, 2 * rank + 1]
        assert res[8]["local_rows"] == 2
        assert res[6]["members"] == list(range(6))
        assert res[6]["local_rows"] == 6
        for k in (8, 6):
            assert len(res[k]["history"][0]["fitness"]) == k
            assert res[k]["history"] == shard_world[0][k]["history"]


def test_pbt_over_the_spread_axis_equals_one_process(shard_world):
    """PBT over the 4 ranks (fitness and rows all-gathered, the same
    draws everywhere) is PBT in one process, bit for bit."""
    prng.seed_all(1234)
    one = PopulationTrainer(build, 8, base_seed=600, evolve="pbt",
                            evolve_every=1, seed=13, device="cpu",
                            build_kwargs={"max_epochs": 2},
                            name="pop_one")
    one.initialize()
    one.run(2)
    w = one.region.read_leaf(one.template.forwards[0].weights)
    for res in shard_world:
        np.testing.assert_array_equal(res[8]["weights"], w)
        np.testing.assert_array_equal(res[8]["lrs"],
                                      one.region.member_lrs())
        assert res[8]["history"] == one.history
