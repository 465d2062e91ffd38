"""Deterministic evolution over the stacked population (port of
``znicz_tpu/population/evolution.py``).

Selection, crossover and truncation are gathers and blends along the
leading member axis of the stacked leaves, on the device.  Each
strategy is split in two:

- a **draw**: every random choice of one generation (PBT's source
  member of each slot, the explored mask and the explore factors; GA's
  two parents, the blend weight β, the rate noise and the elite mask),
  from an explicit ``torch.Generator`` on the device and the fitness;
- an **apply**: a pure function of those draws and the stacked leaves,
  which it writes **in place** (each leaf gathered into a temporary,
  then ``copy_`` back), because the population's captured step reads
  the leaves at the addresses it captured.

The ranking is a stable sort of the negated fitness (ties go to the
lower member index, as ``jnp.argsort`` does), and the engine seeds the
generator from ``(seed, generation)``, so a rerun with one seed replays
the same trajectory.  Fed the reference's draws, an apply gives the
reference's step bit for bit.

- :func:`build_pbt_step`: PBT truncation (Jaderberg et al., 2017) —
  the bottom ``truncation`` share copies a uniformly drawn top
  member's leaves (exploit, exact), then multiplies its rates by a
  factor drawn from ``factors`` (explore);
- :func:`build_ga_step`: GA refill — every non-elite slot becomes a
  child of two size-2 tournament parents, float leaves blended
  ``β·a + (1−β)·b``, the others inherited from parent A, its rates
  log-normally mutated.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


def generation_generator(seed: int, generation: int,
                         device) -> torch.Generator:
    """The generator of one generation: seeded from ``(seed,
    generation)`` through numpy's ``SeedSequence``, on ``device``."""
    state = np.random.SeedSequence([int(seed) & (2 ** 63 - 1),
                                    int(generation)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(state) & (2 ** 63 - 1))
    return gen


def ranking(fitness: np.ndarray) -> np.ndarray:
    """Members best first; ties in member order (a stable sort)."""
    return np.argsort(-np.asarray(fitness, dtype=np.float64),
                      kind="stable")


def tournament(generator: torch.Generator, fitness: torch.Tensor,
               n_draws: int) -> torch.Tensor:
    """``(n_draws,)`` member indices by size-2 tournaments: two members
    drawn uniformly, the fitter kept (ties: the first)."""
    k = fitness.shape[0]
    pairs = torch.randint(0, k, (2, n_draws), generator=generator,
                          device=fitness.device)
    a, b = pairs[0], pairs[1]
    return torch.where(fitness[a] >= fitness[b], a, b)


def truncation_count(n_members: int, truncation: float) -> int:
    """Members replaced a PBT generation: ``round(K·truncation)``, at
    least 1, at most half the population (winners and losers never
    overlap)."""
    if n_members < 2:
        return 0
    n_cut = int(round(n_members * truncation)) or 1
    return max(1, min(n_members // 2, n_cut))


def _bshape(leaf: torch.Tensor, k: int) -> tuple:
    return (k,) + (1,) * (leaf.dim() - 1)


class PBTDraws(NamedTuple):
    """One PBT generation's choices: the member each slot takes its
    leaves from (``src``, int64), the slots that explore (bool) and
    each slot's factor (f32), all ``(K,)`` on the device."""
    src: torch.Tensor
    explored: torch.Tensor
    factors: torch.Tensor


class GADraws(NamedTuple):
    """One GA generation's choices, ``(K,)`` each on the device: the
    elite slots kept (bool), the parents (int64), β and the rate noise
    (f32)."""
    keep: torch.Tensor
    src_a: torch.Tensor
    src_b: torch.Tensor
    beta: torch.Tensor
    noise: torch.Tensor


def draw_pbt(fitness: np.ndarray, generator: torch.Generator, n_cut: int,
             factors: tuple[float, float] = (0.8, 1.25)) -> PBTDraws:
    """The draws of one PBT generation."""
    k = len(fitness)
    dev = generator.device
    order = torch.as_tensor(ranking(fitness), device=dev)
    winners, losers = order[:n_cut], order[k - n_cut:]
    donors = winners[torch.randint(0, n_cut, (n_cut,), generator=generator,
                                   device=dev)]
    src = torch.arange(k, device=dev)
    src[losers] = donors
    explored = torch.zeros(k, dtype=torch.bool, device=dev)
    explored[losers] = True
    coin = torch.rand(k, generator=generator, device=dev) < 0.5
    fac = torch.where(coin, torch.tensor(factors[1], dtype=torch.float32,
                                         device=dev),
                      torch.tensor(factors[0], dtype=torch.float32,
                                   device=dev))
    return PBTDraws(src, explored, fac)


def draw_ga(fitness: np.ndarray, generator: torch.Generator, n_elite: int,
            mutation_sigma: float = 0.2) -> GADraws:
    """The draws of one GA generation."""
    k = len(fitness)
    dev = generator.device
    keep = torch.zeros(k, dtype=torch.bool, device=dev)
    if n_elite:
        keep[torch.as_tensor(ranking(fitness)[:n_elite], device=dev)] = True
    fit = torch.as_tensor(np.asarray(fitness, dtype=np.float32), device=dev)
    src_a = tournament(generator, fit, k)
    src_b = tournament(generator, fit, k)
    beta = torch.rand(k, generator=generator, device=dev,
                      dtype=torch.float32)
    noise = torch.exp(mutation_sigma * torch.randn(
        k, generator=generator, device=dev, dtype=torch.float32))
    return GADraws(keep, src_a, src_b, beta, noise)


def _clip(x: torch.Tensor, bounds) -> torch.Tensor:
    return x if bounds is None else torch.clamp(x, bounds[0], bounds[1])


@torch.no_grad()
def apply_pbt(leaves: Sequence[torch.Tensor], draws: PBTDraws,
              lr_slots=(), lr_bounds=None) -> None:
    """Exploit and explore in place: every leaf's slot *i* takes member
    ``src[i]``'s row; in the leaves at ``lr_slots`` an explored slot's
    row is multiplied by its factor (f32), clipped to ``lr_bounds``."""
    lr_slots = frozenset(lr_slots)
    for i, leaf in enumerate(leaves):
        k = leaf.shape[0]
        src = draws.src.to(leaf.device)
        new = leaf.index_select(0, src)
        if i in lr_slots:
            bs = _bshape(new, k)
            mutated = _clip(new.float()
                            * draws.factors.to(leaf.device).view(bs),
                            lr_bounds)
            new = torch.where(draws.explored.to(leaf.device).view(bs),
                              mutated.to(leaf.dtype), new)
        leaf.copy_(new)


@torch.no_grad()
def apply_ga(leaves: Sequence[torch.Tensor], draws: GADraws,
             blendable: Sequence[bool], lr_slots=(), lr_bounds=None) -> None:
    """Refill in place: each non-elite slot takes parent A's row, blended
    with parent B's in the float leaves (``β·a + (1−β)·b`` in f32, one β
    a child for its whole tree), its rates times the noise (clipped);
    the elite slots keep their rows."""
    lr_slots = frozenset(lr_slots)
    for i, leaf in enumerate(leaves):
        k = leaf.shape[0]
        bs = _bshape(leaf, k)
        dev = leaf.device
        child = leaf.index_select(0, draws.src_a.to(dev))
        if blendable[i]:
            pb = leaf.index_select(0, draws.src_b.to(dev))
            b = draws.beta.to(dev).view(bs)
            child = (b * child.float() + (1.0 - b) * pb.float()).to(
                leaf.dtype)
        if i in lr_slots:
            child = _clip(child.float() * draws.noise.to(dev).view(bs),
                          lr_bounds).to(leaf.dtype)
        leaf.copy_(torch.where(draws.keep.to(dev).view(bs), leaf, child))


def build_pbt_step(n_members: int, lr_slots: Sequence[int],
                   truncation: float = 0.25,
                   factors: tuple[float, float] = (0.8, 1.25),
                   lr_bounds: tuple[float, float] | None = None):
    """``(fn, n_cut)``: ``fn(fitness, generator, *leaves)`` draws one PBT
    generation and applies it to the stacked leaves in place (the
    ``n_cut`` worst members take a top-``n_cut`` member's leaves, then
    their rates at ``lr_slots`` explore)."""
    n_cut = truncation_count(n_members, truncation)
    lr_slots = tuple(lr_slots)

    def fn(fitness, generator, *leaves):
        draws = draw_pbt(fitness, generator, n_cut, factors)
        apply_pbt(leaves, draws, lr_slots, lr_bounds)
        return draws

    return fn, n_cut


def build_ga_step(n_members: int, blendable: Sequence[bool],
                  lr_slots: Sequence[int], elite: int = 1,
                  mutation_sigma: float = 0.2,
                  lr_bounds: tuple[float, float] | None = None):
    """``(fn, n_elite)``: ``fn(fitness, generator, *leaves)`` draws one GA
    generation and applies it to the stacked leaves in place (the top
    ``n_elite`` kept)."""
    n_elite = max(0, min(int(elite), n_members - 1))
    blendable = tuple(bool(b) for b in blendable)
    lr_slots = tuple(lr_slots)

    def fn(fitness, generator, *leaves):
        draws = draw_ga(fitness, generator, n_elite, mutation_sigma)
        apply_ga(leaves, draws, blendable, lr_slots, lr_bounds)
        return draws

    return fn, n_elite
