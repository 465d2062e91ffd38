"""The population engine (port of ``znicz_tpu/population``): K replicas
of one workflow trained together, evolved at epoch boundaries.

- :class:`~znicz_tpu_torch.population.engine.PopulationTrainer` — build
  K members of one sample architecture, train them in one step (one
  CUDA graph per key on the card), evolve them;
- :class:`~znicz_tpu_torch.population.engine.PopulationRegion` — the
  stacked-leaf step itself;
- :mod:`~znicz_tpu_torch.population.evolution` — the deterministic
  selection, crossover, mutation and truncation over the stacked leaves.
"""

from znicz_tpu_torch.population.engine import (PopulationRegion,  # noqa: F401
                                               PopulationTrainer,
                                               harvest_state, leaf_keys,
                                               train_drafter)
from znicz_tpu_torch.population import evolution  # noqa: F401

__all__ = ["PopulationRegion", "PopulationTrainer", "evolution",
           "harvest_state", "leaf_keys", "train_drafter"]
