"""Genetics: hyper-parameter search over workflow configs (port of
``znicz_tpu/genetics.py``).

Config values declared as ranges (:class:`Tune`), a population of
candidate configs, each scored by training a workflow, evolved by
selection, crossover and mutation (the reference's ``veles/genetics``).
:class:`Tune`, :func:`collect_tunes`, :func:`apply_genome`, the
snapshot/restore pair and :func:`workflow_fitness` are host code, copied;
the GA draws from numpy, so from one seed the port proposes the
reference's genomes.

Two backends score a generation:

- ``"process"``: one sequential training per fresh genome on this
  process's device; over several processes (``torch.distributed``)
  process *p* trains ``genomes[p::count]`` and the scores merge in one
  exact all-gather
  (:mod:`~znicz_tpu_torch.parallel.process_shard`);
- ``"mesh"``: the whole generation as one population
  (:class:`~znicz_tpu_torch.population.PopulationTrainer`, ``evolve=None``,
  each member its genome's learning rate as device state).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from znicz_tpu_torch.parallel.process_shard import (allgather_sum,
                                                    merge_sharded_scores,
                                                    process_info)
from znicz_tpu_torch.utils.logger import Logger


class Tune:
    """A tunable config leaf: default value + inclusive range
    (reference: ``veles/genetics/config.py`` ``Tune``)."""

    def __init__(self, default, min_value, max_value,
                 is_int: bool | None = None) -> None:
        if not (min_value <= default <= max_value):
            raise ValueError(
                f"Tune default {default} outside [{min_value}, "
                f"{max_value}]")
        self.default = default
        self.min_value = min_value
        self.max_value = max_value
        self.is_int = (isinstance(default, (int, np.integer))
                       and not isinstance(default, bool)
                       if is_int is None else is_int)

    def clip(self, value):
        value = min(max(value, self.min_value), self.max_value)
        return int(round(value)) if self.is_int else float(value)

    def sample(self, rng: np.random.Generator):
        if self.is_int:
            return int(rng.integers(self.min_value, self.max_value + 1))
        return float(rng.uniform(self.min_value, self.max_value))

    def __repr__(self) -> str:
        return (f"Tune({self.default}, {self.min_value}, "
                f"{self.max_value})")


def collect_tunes(node, prefix: str = "") -> dict[str, Tune]:
    """Walk a :class:`~znicz_tpu_torch.utils.config.Config` subtree and pull
    out every ``Tune`` leaf (reference behavior: config files wrap
    leaves in ``Tune`` and genetics discovers them)."""
    from znicz_tpu_torch.utils.config import Config
    out: dict[str, Tune] = {}
    for name, value in node.items():
        path = f"{prefix}{name}"
        if isinstance(value, Tune):
            out[path] = value
        elif isinstance(value, Config):
            out.update(collect_tunes(value, prefix=f"{path}."))
    return out


def apply_genome(genome: dict[str, Any]) -> dict[str, Any]:
    """Split a genome into build-kwargs (plain keys) and config-tree
    writes (dotted keys, applied to ``root`` immediately).

    The writes are global state: callers that evaluate MANY genomes
    (the GA's fitness loop) must bracket each evaluation with
    :func:`snapshot_genome_leaves` / :func:`restore_genome_leaves`, or
    the tree keeps whatever candidate ran last —
    :meth:`GeneticsOptimizer.run` restores around every evaluation and
    re-applies the BEST genome on exit."""
    from znicz_tpu_torch.utils.config import root
    kwargs = {}
    for key, value in genome.items():
        if "." in key:
            node = root
            parts = key.split(".")
            for part in parts[:-1]:
                node = getattr(node, part)
            setattr(node, parts[-1], value)
        else:
            kwargs[key] = value
    return kwargs


#: sentinel for "this leaf did not exist before apply_genome"
_MISSING = object()


def snapshot_genome_leaves(genome: dict[str, Any]) -> dict[str, Any]:
    """Current values of the genome's dotted config leaves (the state
    :func:`apply_genome` is about to clobber — typically the ``Tune``
    objects the search space was collected from)."""
    from znicz_tpu_torch.utils.config import root
    snap: dict[str, Any] = {}
    for key in genome:
        if "." not in key:
            continue
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = getattr(node, part)
        snap[key] = node.__dict__.get(parts[-1], _MISSING)
    return snap


def restore_genome_leaves(snapshot: dict[str, Any]) -> None:
    """Undo :func:`apply_genome`'s config-tree writes: put back the
    snapshotted values, deleting leaves that did not exist."""
    from znicz_tpu_torch.utils.config import root
    for key, value in snapshot.items():
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = getattr(node, part)
        if value is _MISSING:
            node.__dict__.pop(parts[-1], None)
        else:
            setattr(node, parts[-1], value)


def workflow_fitness(workflow) -> float:
    """Score a trained workflow: negated validation metric (higher is
    better).  The one metric-extraction point for every GA driver."""
    d = workflow.decision
    if getattr(d, "min_validation_n_err_pt", None) is not None:
        return -float(d.min_validation_n_err_pt)
    if getattr(d, "min_validation_mse", None) is not None:
        return -float(d.min_validation_mse)
    raise ValueError("decision exposes no validation metric")


class GeneticsOptimizer(Logger):
    """Evolve workflow hyperparameters.

    Parameters
    ----------
    build_fn:
        ``callable(**overrides) -> Workflow`` (a sample's ``build``).
    space:
        genome layout: key → :class:`Tune`.  Plain keys become
        ``build_fn`` kwargs; dotted keys are config-tree leaves.
    fitness_fn:
        ``callable(genome) -> float`` (higher is better).  Default:
        build + train the workflow and return
        ``-min_validation_n_err_pt`` (or ``-min_validation_mse``).
    backend:
        ``"process"`` (default — one sequential training per fresh
        genome; spread over the processes of a ``torch.distributed``
        world, the multi-host path) or ``"mesh"`` — score a WHOLE
        generation in one population run: K replicas of the
        architecture trained together in one step (one CUDA graph per
        key on the card; the member axis spread over ``mesh``'s data
        axis), each member carrying its genome's learning rate as
        device state.  The mesh backend requires ``build_fn`` and a
        single-key search space named ``learning_rate`` (or any dotted
        path ending in it) — the one hyperparameter that is per-member
        device state; anything that changes the architecture still
        needs the process backend.
    device_factory:
        ``callable() -> device spec`` giving where a candidate trains
        (``"cpu"``, ``"numpy"``); None is the card, an error without
        one.
    """

    def __init__(self, build_fn: Callable | None = None,
                 space: dict[str, Tune] | None = None,
                 population_size: int = 8,
                 generations: int = 5,
                 elite: int = 1,
                 mutation_rate: float = 0.25,
                 mutation_sigma: float = 0.2,
                 seed: int = 1234,
                 fitness_fn: Callable[[dict], float] | None = None,
                 device_factory: Callable | None = None,
                 train_kwargs: dict | None = None,
                 backend: str = "process",
                 mesh=None) -> None:
        super().__init__()
        if space is None or not space:
            raise ValueError("empty search space")
        if backend not in ("process", "mesh"):
            raise ValueError(f"unknown genetics backend '{backend}'")
        if backend == "mesh":
            if build_fn is None:
                raise ValueError("mesh backend needs build_fn")
            if fitness_fn is not None:
                raise ValueError(
                    "mesh backend scores through the population "
                    "engine — it cannot take a custom fitness_fn")
            bad = [k for k in space
                   if k != "learning_rate"
                   and not k.endswith(".learning_rate")]
            if bad or len(space) != 1:
                raise ValueError(
                    f"mesh backend tunes exactly one learning_rate "
                    f"key (per-member device state); got "
                    f"{sorted(space)} — use backend='process' for "
                    f"architecture-changing genomes")
        self.backend = backend
        self.mesh = mesh
        self.build_fn = build_fn
        self.space = dict(space)
        self.population_size = int(population_size)
        self.generations = int(generations)
        self.elite = max(0, int(elite))
        self.mutation_rate = float(mutation_rate)
        self.mutation_sigma = float(mutation_sigma)
        self.rng = np.random.default_rng(seed)
        self.fitness_fn = fitness_fn or self._train_fitness
        self.device_factory = device_factory
        self.train_kwargs = dict(train_kwargs or {})
        self.history: list[dict] = []   # per-generation stats
        self.best_genome: dict | None = None
        self.best_fitness = -np.inf
        self._cache: dict[tuple, float] = {}
        #: genome keys THIS process trained (disjoint across processes
        #: in multi-process mode; every fresh genome in single-process)
        self.local_evaluated: list[tuple] = []

    # ------------------------------------------------------------------
    def _train_fitness(self, genome: dict) -> float:
        """Default fitness: train a fresh workflow, score validation.

        The genome's dotted config writes are scoped to THIS
        evaluation: the touched leaves are snapshotted before
        ``apply_genome`` and restored after — the next candidate (and
        the caller) sees the tree it started from, not whatever genome
        happened to run last."""
        from znicz_tpu_torch.utils import prng
        from znicz_tpu_torch.utils.config import root
        if self.build_fn is None:
            raise ValueError("no build_fn and no fitness_fn given")
        # same init/shuffle stream per candidate, from the documented
        # config seed (matches the CLI --optimize path)
        prng.seed_all(root.common.seed)
        snapshot = snapshot_genome_leaves(genome)
        try:
            kwargs = apply_genome(genome)
            kwargs.update(self.train_kwargs)
            wf = self.build_fn(**kwargs)
            # multi-process: evaluates on this process's device only —
            # each genome is an independent run, no collectives
            wf.initialize(device=self._eval_device())
            wf.run()
            return workflow_fitness(wf)
        finally:
            restore_genome_leaves(snapshot)

    def _eval_device(self):
        return self.device_factory() if self.device_factory else None

    # ------------------------------------------------------------------
    def _genome_lr(self, genome: dict) -> float:
        """The single learning-rate value a mesh-backend genome
        carries (validated at construction)."""
        return float(next(iter(genome.values())))

    def _score_population_mesh(self, pending: list[tuple]) -> None:
        """Mesh backend: score the generation's fresh genomes in ONE
        population run — K stacked members, identical init/shuffle
        stream (``prng.seed_all(root.common.seed)``, the same contract
        ``_train_fitness`` gives every candidate), one learning rate
        per member.  Fitness per member is ``-min`` validation error
        over the run, exactly :func:`workflow_fitness`'s number."""
        from znicz_tpu_torch.population import PopulationTrainer
        from znicz_tpu_torch.utils.config import root
        lrs = [self._genome_lr(genome) for _, genome in pending]
        seed = int(root.common.seed)
        trainer = PopulationTrainer(
            self.build_fn, len(pending),
            member_seeds=[seed] * len(pending),
            build_kwargs=dict(self.train_kwargs),
            mesh=self.mesh, member_lrs=lrs, evolve=None,
            name="genetics-mesh", device=self._eval_device())
        trainer.initialize()
        trainer.run()
        for (key, _), fit in zip(pending,
                                 trainer.member_best_fitness):
            self.local_evaluated.append(key)
            self._cache[key] = float(fit)

    # ------------------------------------------------------------------
    # GA machinery
    # ------------------------------------------------------------------
    def _initial_population(self) -> list[dict]:
        pop = [{k: t.default for k, t in self.space.items()}]
        while len(pop) < self.population_size:
            pop.append({k: t.sample(self.rng)
                        for k, t in self.space.items()})
        return pop

    def _crossover(self, a: dict, b: dict) -> dict:
        """Uniform crossover with arithmetic blending on floats."""
        child = {}
        for key, tune in self.space.items():
            if tune.is_int:
                child[key] = a[key] if self.rng.random() < 0.5 else b[key]
            else:
                w = self.rng.random()
                child[key] = tune.clip(w * a[key] + (1 - w) * b[key])
        return child

    def _mutate(self, genome: dict) -> dict:
        out = dict(genome)
        for key, tune in self.space.items():
            if self.rng.random() >= self.mutation_rate:
                continue
            span = tune.max_value - tune.min_value
            if tune.is_int:
                step = max(1, int(round(span * self.mutation_sigma)))
                out[key] = tune.clip(
                    out[key] + int(self.rng.integers(-step, step + 1)))
            else:
                out[key] = tune.clip(
                    out[key]
                    + self.rng.normal(0.0, span * self.mutation_sigma))
        return out

    def _score_population(self, population: list[dict]) -> list[float]:
        """Score one generation; over several processes, process *p*
        trains the fresh genomes ``pending[p::process_count]`` and the
        scores merge in one all-gather (docstring contract above).
        Cache hits (elites, duplicate children) never retrain."""
        keys = [tuple(sorted(g.items())) for g in population]
        pending, seen = [], set()
        for key, genome in zip(keys, population):
            if key not in self._cache and key not in seen:
                seen.add(key)
                pending.append((key, genome))
        pidx, pcount = process_info()
        if self.backend == "mesh":
            if pending:
                self._score_population_mesh(pending)
            return [self._cache[k] for k in keys]
        if pcount > 1 and pending:
            # a local fitness exception must not raise before the
            # collectives (a lone raise would leave peers blocked in
            # process_allgather): record it, gather an explicit
            # failure flag, raise together.  A legitimately-NaN
            # fitness is NOT a failure — it caches and sorts exactly
            # as in the single-process path.
            scores = np.zeros(len(pending), np.float64)
            local_exc: Exception | None = None
            for i in range(pidx, len(pending), pcount):
                key, genome = pending[i]
                self.local_evaluated.append(key)
                try:
                    scores[i] = float(self.fitness_fn(dict(genome)))
                except Exception as exc:
                    local_exc = exc
                    break
            if allgather_sum(
                    np.array([1.0 if local_exc else 0.0]))[0] > 0:
                raise RuntimeError(
                    "fitness evaluation failed on a process; every "
                    "process aborts the GA together") from local_exc
            merged = merge_sharded_scores(scores, pcount)
            for i, (key, _) in enumerate(pending):
                self._cache[key] = float(merged[i])
        else:
            for key, genome in pending:
                self.local_evaluated.append(key)
                self._cache[key] = float(self.fitness_fn(dict(genome)))
        return [self._cache[k] for k in keys]

    def _select(self, scored: list[tuple[float, dict]]) -> dict:
        """Tournament of 2 over the current generation."""
        i, j = self.rng.integers(0, len(scored), size=2)
        return scored[i][1] if scored[i][0] >= scored[j][0] \
            else scored[j][1]

    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Evolve; returns the best genome found."""
        population = self._initial_population()
        for gen in range(self.generations):
            scores = self._score_population(population)
            scored = sorted(
                zip(scores, population),
                key=lambda t: t[0], reverse=True)
            if scored[0][0] > self.best_fitness:
                self.best_fitness, self.best_genome = \
                    scored[0][0], dict(scored[0][1])
            fits = [s for s, _ in scored]
            self.history.append({
                "generation": gen,
                "best": fits[0],
                "mean": float(np.mean(fits)),
                "best_genome": dict(scored[0][1])})
            self.info(
                "generation %d: best %.4f mean %.4f (%s)", gen,
                fits[0], float(np.mean(fits)), scored[0][1])
            next_pop = [dict(g) for _, g in scored[:self.elite]]
            while len(next_pop) < self.population_size:
                child = self._crossover(self._select(scored),
                                        self._select(scored))
                next_pop.append(self._mutate(child))
            population = next_pop
        assert self.best_genome is not None
        # per-candidate writes were restored after each evaluation;
        # leave the tree holding the WINNER's values (callers build
        # the final model straight off root)
        apply_genome(self.best_genome)
        return self.best_genome
