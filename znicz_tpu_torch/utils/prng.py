"""Seeded deterministic random generators (port of
``znicz_tpu/utils/prng.py``).

One named registry of :class:`RandomGenerator` objects (``prng.get()``
returns the default).  Each generator owns

- a host ``numpy.random.Generator`` for control-plane randomness
  (weight fills done on the host, the loader's shuffle seed) — the
  reference's, copied: ``numpy.random.default_rng(seed)``, so the same
  seed fills the same initial weights in the same construction order
  in both packages;
- a ``torch.Generator`` in place of the reference's jax key chain, for
  device randomness.  Nothing on the sequence-training path draws from
  it yet; its streams differ from the reference's bit for bit (only
  statistical parity is owed there).

A state (:meth:`RandomGenerator.get_state`) has the reference's keys, so
a snapshot loads in either package: the reference's ``jax_key`` is kept
as it came, or, for a generator seeded here, written as the key the
reference derives from the seed (``jax.random.key(seed)``'s data,
``[0, seed mod 2³²]``).
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.utils.config import root


class RandomGenerator:
    def __init__(self, seed: int | None = None, name: str = "default") -> None:
        self.name = name
        self.seed(seed if seed is not None else int(root.common.seed))

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self.numpy = np.random.default_rng(self._seed)
        self.torch = torch.Generator().manual_seed(self._seed)
        self._jax_key: np.ndarray | None = None

    # --- host-side fills and draws (the reference's, copied) -----------
    def fill_uniform(self, shape, vmin: float, vmax: float,
                     dtype=np.float32) -> np.ndarray:
        return self.numpy.uniform(vmin, vmax, size=shape).astype(dtype)

    def fill_normal(self, shape, mean: float = 0.0, stddev: float = 1.0,
                    dtype=np.float32) -> np.ndarray:
        return self.numpy.normal(mean, stddev, size=shape).astype(dtype)

    def permutation(self, n: int) -> np.ndarray:
        return self.numpy.permutation(n)

    def randint(self, low: int, high: int, size=None):
        return self.numpy.integers(low, high, size=size)

    def get_state(self) -> dict:
        """Serializable state: the seed, the host stream's state and the
        reference's device key (the reference's keys; the torch stream
        is re-derived from the seed)."""
        key = self._jax_key
        if key is None:
            key = np.array([0, self._seed & 0xFFFFFFFF], dtype=np.uint32)
        return {"seed": self._seed,
                "numpy_state": self.numpy.bit_generator.state,
                "jax_key": key.copy()}

    def set_state(self, state: dict) -> None:
        """Adopt a state from :meth:`get_state` or from the reference's
        ``get_state`` (whose ``jax_key`` is only carried along)."""
        self.seed(int(state["seed"]))
        self.numpy.bit_generator.state = state["numpy_state"]
        if state.get("jax_key") is not None:
            self._jax_key = np.asarray(state["jax_key"], dtype=np.uint32)


_generators: dict[str, RandomGenerator] = {}


def get(name: str = "default") -> RandomGenerator:
    gen = _generators.get(name)
    if gen is None:
        gen = _generators[name] = RandomGenerator(name=name)
    return gen


def seed_all(seed: int) -> None:
    """Reseed every registered generator."""
    root.common.seed = int(seed)
    for gen in _generators.values():
        gen.seed(seed)
    if "default" not in _generators:
        get("default")
