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
  device randomness.  Nothing on the training paths draws from it; its
  streams differ from the reference's bit for bit (only statistical
  parity is owed there).

The stochastic units (dropout, stochastic pooling) draw their per-step
seeds from a :class:`SeedChain`: a seed that lives on the device and
that the step itself advances, rooted in one draw from the default
generator.  A captured CUDA graph replays the advance with the step, so
each replay gets its own seed with no host work in between, and the
eager and graphed runs of one workflow see the same seeds.

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
#: bumped by every :func:`seed_all`: a :class:`SeedChain` rooted before
#: it draws its root again
_generation = 0


def get(name: str = "default") -> RandomGenerator:
    gen = _generators.get(name)
    if gen is None:
        gen = _generators[name] = RandomGenerator(name=name)
    return gen


def seed_all(seed: int) -> None:
    """Reseed every registered generator."""
    global _generation
    _generation += 1
    root.common.seed = int(seed)
    for gen in _generators.values():
        gen.seed(seed)
    if "default" not in _generators:
        get("default")


#: the chain's step: odd, so the 63-bit seeds run through all 2⁶³
#: values before one repeats (the golden-ratio constant, cut to 62 bits)
CHAIN_STRIDE = 0x9E3779B97F4A7C15 >> 2 | 1
_MASK63 = 2 ** 63 - 1


class SeedChain:
    """A chain of 63-bit seeds held in a 0-d int64 device tensor.

    The chain is rooted lazily, at the first :meth:`next`, in one draw
    ``randint(0, 2**63)`` from the default generator, and rooted again
    after a :func:`seed_all`.  :meth:`next` returns this step's seed as
    a new tensor and advances the chain on the device
    (``(s + CHAIN_STRIDE) mod 2⁶³``), with no host sync, so a CUDA graph
    that captures a step advances it on every replay.  The chain tensor
    keeps its address: a root or a snapshot's value is written into it
    in place.
    """

    def __init__(self, name: str = "default") -> None:
        self.prng_name = name
        self.state: torch.Tensor | None = None
        self._generation = -1
        self._pending: int | None = None

    def sync(self, device) -> None:
        """Root (or re-root) the chain on ``device`` when it has no
        value yet, a :func:`seed_all` came since its root, or a
        snapshot's value waits.  Host work: never inside a capture."""
        if self._pending is not None:
            value = self._pending
        elif self.state is None or self._generation != _generation:
            value = int(get(self.prng_name).randint(0, 2 ** 63))
        else:
            return
        self._pending = None
        self._generation = _generation
        if self.state is None or self.state.device != torch.device(device):
            self.state = torch.full((), value, dtype=torch.int64,
                                    device=device)
        else:
            self.state.fill_(value)

    def next(self, device) -> torch.Tensor:
        """This step's seed (a new 0-d tensor), the chain advanced."""
        capturing = (torch.device(device).type == "cuda"
                     and torch.cuda.is_current_stream_capturing())
        if not capturing:
            self.sync(device)
        seed = self.state.clone()
        self.state.add_(CHAIN_STRIDE).bitwise_and_(_MASK63)
        return seed

    def get_value(self) -> int | None:
        """The chain's next seed (host read), None before its root."""
        if self._pending is not None:
            return self._pending
        return None if self.state is None else int(self.state)

    def set_value(self, value: int) -> None:
        """Continue from ``value`` (a snapshot's), written in place at the
        next :meth:`sync`."""
        self._pending = int(value)
