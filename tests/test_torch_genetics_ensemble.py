"""The port's genetic search and ensemble (``znicz_tpu_torch.genetics``,
``znicz_tpu_torch.ensemble``, ``--optimize``) on the CPU: the cases of
``tests/test_genetics_ensemble.py`` through the port, and the GA held to
the reference's: from one seed, over a pure-Python fitness, the port
proposes the reference's genomes, generation by generation (both draw
from numpy's ``default_rng``)."""

from __future__ import annotations

import numpy as np
import pytest

from znicz_tpu.genetics import GeneticsOptimizer as RefOptimizer
from znicz_tpu.genetics import Tune as RefTune
from znicz_tpu_torch.ensemble import Ensemble, class_forward_pass
from znicz_tpu_torch.genetics import (GeneticsOptimizer, Tune, apply_genome,
                                      collect_tunes)
from znicz_tpu_torch.loader.base import VALID
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def test_tune_basics():
    t = Tune(0.1, 0.01, 1.0)
    assert not t.is_int
    assert t.clip(5.0) == 1.0 and t.clip(-1) == 0.01
    ti = Tune(8, 2, 64)
    assert ti.is_int
    assert ti.clip(3.4) == 3
    with pytest.raises(ValueError):
        Tune(2.0, 0.0, 1.0)


def test_collect_tunes_and_apply_genome():
    root.gen_test.lr = Tune(0.1, 0.01, 1.0)
    root.gen_test.nested.units = Tune(8, 2, 64)
    space = collect_tunes(root.gen_test)
    assert set(space) == {"lr", "nested.units"}
    kwargs = apply_genome({"gen_test.lr": 0.5, "hidden": 16})
    assert kwargs == {"hidden": 16}
    assert root.gen_test.lr == 0.5


QUADRATIC = {"x": (0.0, -4.0, 4.0), "y": (0.0, -4.0, 4.0), "k": (10, 1, 20)}


def _quadratic(g):
    return -((g["x"] - 2.0) ** 2 + (g["y"] + 1.0) ** 2
             + 0.05 * (g["k"] - 7) ** 2)


def test_ga_optimizes_quadratic():
    opt = GeneticsOptimizer(
        space={k: Tune(*v) for k, v in QUADRATIC.items()},
        fitness_fn=_quadratic, population_size=16, generations=12, seed=5)
    best = opt.run()
    assert opt.best_fitness > -0.5
    assert abs(best["x"] - 2.0) < 0.7
    assert abs(best["y"] + 1.0) < 0.7
    assert len(opt.history) == 12
    bests = [h["best"] for h in opt.history]
    assert bests[-1] >= bests[0]


def test_ga_proposes_the_reference_genomes():
    """One seed, one space, one fitness: every generation's scored
    genomes, its best and its mean are the reference's."""
    seen = {"port": [], "ref": []}

    def recording(name):
        def fitness(g):
            seen[name].append(dict(g))
            return _quadratic(g)
        return fitness

    port = GeneticsOptimizer(
        space={k: Tune(*v) for k, v in QUADRATIC.items()},
        fitness_fn=recording("port"), population_size=10, generations=6,
        seed=17)
    ref = RefOptimizer(
        space={k: RefTune(*v) for k, v in QUADRATIC.items()},
        fitness_fn=recording("ref"), population_size=10, generations=6,
        seed=17)
    assert port.run() == ref.run()
    assert seen["port"] == seen["ref"]
    assert port.history == ref.history
    assert port.best_fitness == ref.best_fitness


def test_ga_caches_fitness_calls():
    calls = {"n": 0}

    def fitness(g):
        calls["n"] += 1
        return -g["x"] ** 2

    opt = GeneticsOptimizer(
        space={"x": Tune(1.0, -2.0, 2.0)}, fitness_fn=fitness,
        population_size=6, generations=4, seed=0)
    opt.run()
    assert calls["n"] < 6 * 4


def test_train_fitness_restores_config_leaves():
    from znicz_tpu_torch.models.samples.wine import build

    root.wine.learning_rate = Tune(0.3, 0.05, 0.8)
    opt = GeneticsOptimizer(
        build_fn=build,
        space={"wine.learning_rate": Tune(0.3, 0.05, 0.8)},
        population_size=2, generations=1, seed=7,
        device_factory=lambda: "numpy",
        train_kwargs={"max_epochs": 1})
    opt._train_fitness({"wine.learning_rate": 0.11})
    assert isinstance(root.wine.learning_rate, Tune)


def test_ga_run_leaves_best_genome_in_root():
    from znicz_tpu_torch.models.samples.wine import build

    opt = GeneticsOptimizer(
        build_fn=build,
        space={"wine.learning_rate": Tune(0.3, 0.05, 0.8)},
        population_size=3, generations=2, seed=7,
        device_factory=lambda: "numpy",
        train_kwargs={"max_epochs": 2})
    best = opt.run()
    assert root.wine.learning_rate == best["wine.learning_rate"]


def test_snapshot_restore_handles_missing_leaves():
    from znicz_tpu_torch.genetics import (restore_genome_leaves,
                                          snapshot_genome_leaves)

    genome = {"gen_leak.fresh.leaf": 3.5, "plain_kwarg": 1}
    snap = snapshot_genome_leaves(genome)
    apply_genome(genome)
    assert root.gen_leak.fresh.leaf == 3.5
    restore_genome_leaves(snap)
    assert "leaf" not in root.gen_leak.fresh.__dict__


def test_ga_trains_wine():
    from znicz_tpu_torch.models.samples.wine import build

    opt = GeneticsOptimizer(
        build_fn=build, space={"learning_rate": Tune(0.3, 0.05, 0.8)},
        population_size=3, generations=2, seed=7,
        device_factory=lambda: "cpu",
        train_kwargs={"max_epochs": 3})
    best = opt.run()
    assert 0.05 <= best["learning_rate"] <= 0.8
    assert opt.best_fitness >= -100.0


def _wine_build(**overrides):
    from znicz_tpu_torch.models.samples.wine import build
    overrides.setdefault("max_epochs", 4)
    return build(**overrides)


def test_ensemble_votes_better_or_equal():
    ens = Ensemble(_wine_build, n_models=3, base_seed=42,
                   device_factory=lambda: "numpy")
    ens.train()
    assert len(ens.workflows) == 3
    result = ens.evaluate(VALID)
    assert result["n_samples"] == 28  # the UCI set: 178 − 150 train
    assert len(result["member_err_pt"]) == 3
    assert result["ensemble_err_pt"] <= min(result["member_err_pt"]) + 8.0


def test_class_forward_pass_covers_split():
    from znicz_tpu_torch.utils import prng

    prng.seed_all(1)
    wf = _wine_build(max_epochs=2)
    wf.initialize(device="numpy")
    wf.run()
    outputs, labels = class_forward_pass(wf, VALID)
    assert len(outputs) == 28 and len(labels) == 28
    probs = np.stack(list(outputs.values()))
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-4)


def test_ensemble_evaluate_xla_region():
    """The aggregate pass runs through the training step's region (the
    CPU device; a CUDA graph on the card) and gives each sample a
    probability row."""
    ens = Ensemble(_wine_build, n_models=2, base_seed=3,
                   device_factory=lambda: "cpu",
                   train_kwargs={"max_epochs": 2})
    ens.train()
    result = ens.evaluate(VALID)
    assert result["n_samples"] == 28
    assert 0.0 <= result["ensemble_err_pt"] <= 100.0
    outputs, _ = class_forward_pass(ens.workflows[0], VALID)
    probs = np.stack(list(outputs.values()))
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-4)


def _ref_wine_build(**overrides):
    from znicz_tpu.models.samples.wine import build
    overrides.setdefault("max_epochs", 4)
    return build(**overrides)


@pytest.mark.parametrize("backend", ["process", "mesh"])
def test_ensemble_matches_the_reference(backend, monkeypatch):
    """Three Wine members from one base seed, trained by the port on the
    CPU device and by the reference on its XLA device: the member
    errors, the vote and the sample count are equal, and (process
    backend) each member's class probabilities in the aggregate pass
    agree within 1e-5 of their largest |value| (f32 sums in another
    order).  The probabilities are recorded as ``evaluate`` makes them:
    the reference's pass over the XLA region runs the schedule from its
    device cursor, so only the first pass after training reads the
    validation rows (ROADMAP C20).  The port's pass repeats."""
    import znicz_tpu.ensemble as ref_ensemble
    import znicz_tpu_torch.ensemble as port_ensemble
    from znicz_tpu.backends import XLADevice

    passes = {"port": [], "ref": []}
    for name, module in (("port", port_ensemble), ("ref", ref_ensemble)):
        def recording(wf, klass, _name=name,
                      _forward=module.class_forward_pass):
            outputs, labels = _forward(wf, klass)
            passes[_name].append((outputs, labels))
            return outputs, labels
        monkeypatch.setattr(module, "class_forward_pass", recording)

    port = Ensemble(_wine_build, n_models=3, base_seed=42, backend=backend,
                    device_factory=lambda: "cpu")
    ref = ref_ensemble.Ensemble(_ref_wine_build, n_models=3, base_seed=42,
                                backend=backend, device_factory=XLADevice)
    port.train()
    ref.train()
    result = port.evaluate(VALID)
    want = ref.evaluate(VALID)
    assert result["n_samples"] == want["n_samples"] == 28
    assert result["member_err_pt"] == want["member_err_pt"]
    assert result["ensemble_err_pt"] == want["ensemble_err_pt"]
    assert [s["validation_err_pt"] for s in port.member_stats] == \
        [s["validation_err_pt"] for s in ref.member_stats]
    assert len(passes["port"]) == len(passes["ref"]) == (
        3 if backend == "process" else 0)
    for (got, got_labels), (exp, exp_labels) in zip(passes["port"],
                                                    passes["ref"]):
        assert got_labels == exp_labels
        assert sorted(got) == sorted(exp) == list(range(28))
        got_rows = np.stack([got[i] for i in range(28)])
        exp_rows = np.stack([exp[i] for i in range(28)])
        np.testing.assert_allclose(
            got_rows, exp_rows, rtol=0,
            atol=1e-5 * float(np.abs(exp_rows).max()))
    for wf, (outputs, labels) in zip(port.workflows, passes["port"]):
        again, again_labels = port_ensemble.class_forward_pass(wf, VALID)
        assert again_labels == labels
        for i in range(28):
            np.testing.assert_array_equal(again[i], outputs[i])


def test_cli_optimize_wine():
    from znicz_tpu_torch.__main__ import Main

    main = Main()
    rc = main.run([
        "wine", "--backend", "numpy", "--optimize", "2x3",
        "--root", "wine.max_epochs=2",
        "--root", "wine.learning_rate=Tune(0.3, 0.05, 0.8)"])
    assert rc == 0
    best = main.best_genome
    assert set(best) == {"wine.learning_rate"}
    assert 0.05 <= best["wine.learning_rate"] <= 0.8


def test_cli_optimize_without_tunes_errors():
    from znicz_tpu_torch.__main__ import Main

    rc = Main().run(["wine", "--backend", "numpy", "--optimize", "1x2",
                     "--root", "wine.max_epochs=1"])
    assert rc == 1


def test_cli_optimize_on_the_cpu_matches_the_reference_search():
    """``-b cpu --optimize 2x3`` proposes the reference's genomes from the
    same seed (its GA draws from numpy); the best is one of them, in
    range."""
    from znicz_tpu_torch.__main__ import Main

    main = Main()
    assert main.run([
        "wine", "-b", "cpu", "--optimize", "2x3",
        "--root", "wine.max_epochs=2",
        "--root", "wine.learning_rate=Tune(0.3, 0.05, 0.8)"]) == 0
    assert 0.05 <= main.best_genome["wine.learning_rate"] <= 0.8
    ref = RefOptimizer(space={"wine.learning_rate": RefTune(0.3, 0.05, 0.8)},
                       fitness_fn=lambda g: 0.0, population_size=3,
                       generations=1, seed=int(root.common.seed))
    first = ref._initial_population()
    port = GeneticsOptimizer(space={"wine.learning_rate": Tune(0.3, 0.05,
                                                               0.8)},
                             fitness_fn=lambda g: 0.0, population_size=3,
                             generations=1, seed=int(root.common.seed))
    assert port._initial_population() == first
