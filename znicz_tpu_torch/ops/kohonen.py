"""Kohonen self-organizing map units (port of ``znicz_tpu/ops/kohonen.py``):
``KohonenForward`` and ``KohonenTrainer``, which drive the ``kohonen``
sample.

- :class:`KohonenForward`: the winner neuron of each sample,
  ``argmin ‖x − w_i‖²`` over an ``sy × sx`` grid of neurons (the first
  minimum, as numpy's ``argmin``), the winner's squared distance as
  ``output``, and each neuron's hits, counted on the device.
- :class:`KohonenTrainer`: the batch SOM update with a Gaussian
  neighbourhood whose radius and rate decay exponentially:

  .. code-block:: text

      h_bi  = exp(−‖grid(win_b) − grid(i)‖² / (2σ(t)²))
      W    += lr(t)/n · Σ_b h_bi (x_b − w_i)

On a device the distances are one product (‖x‖² − 2xWᵀ + ‖w‖²) and the
update two more (Hᵀx and the column sums of H), in f32 with autograd
off.  The hits are an int32 ``index_add_`` of a fixed size (exact, and
no sync: a ``bincount`` would size its result from the data).  The
decay clock ``time`` is a 0-d f32 tensor that the trainer reads and
advances on the device, so a replayed CUDA graph takes each step's
schedule with no host work.  The trainer writes the shared ``weights``
in place, and the decision zeroes ``hits`` in place once an epoch: a
captured graph reads and writes the tensors it captured.

On the numpy oracle each unit runs the reference's numpy path.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import (Forward, ModuleUnit, as_numpy,
                                          stored_f32)
from znicz_tpu_torch.utils import prng


def grid_coords(sy: int, sx: int) -> np.ndarray:
    """(sy·sx, 2) float grid coordinates, row-major."""
    yy, xx = np.mgrid[0:sy, 0:sx]
    return np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float32)


class KohonenForward(Forward):
    """The winner lookup; ``weights`` (n_neurons, features) is shared
    with the trainer.  Weights loaded before ``initialize``
    (:meth:`~Forward.load_params`) are kept, else the reference's fill
    draws them."""

    EXPORT_PARAMS = ("weights",)

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 shape: tuple[int, int] = (8, 8), **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, include_bias=False,
                         **kwargs)
        self.shape_grid = (int(shape[0]), int(shape[1]))
        self.winners = None               # (n,) int32, this step's
        self.register_buffer("hits", None)

    @property
    def n_neurons(self) -> int:
        return self.shape_grid[0] * self.shape_grid[1]

    @property
    def output_shape(self) -> tuple:
        return ()

    def param_shapes(self) -> dict[str, tuple]:
        return {"weights": (self.n_neurons, int(np.prod(self.input_shape)))}

    def initial_params(self) -> dict[str, np.ndarray]:
        features = int(np.prod(self.input_shape))
        return {"weights": self.fill_array(
            self.param_shapes()["weights"], self.weights_filling,
            self.weights_stddev, fan_in=features)}

    def init_params(self, device) -> None:
        if getattr(self, "weights", None) is None:
            super().init_params(device)
        if self.hits is None:
            self.hits = torch.zeros(self.n_neurons, dtype=torch.int32)
        self.to(device)

    @staticmethod
    def distances(xp, x, w):
        """(n, n_neurons) squared euclidean distances through one
        product."""
        x2 = (x * x).sum(axis=1)[:, None]
        w2 = (w * w).sum(axis=1)[None, :]
        return x2 - 2.0 * (x @ w.T) + w2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lookup(x)[1]

    @torch.no_grad()
    def lookup(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(winners int32, the winners' squared distances)`` of a
        batch."""
        n = x.shape[0]
        d = self.distances(torch, x.reshape(n, -1).float(), self.weights)
        win = torch.argmin(d, dim=1)
        return win.to(torch.int32), d.gather(1, win[:, None])[:, 0]

    @torch.no_grad()
    def device_run(self) -> None:
        self.winners, self.output = self.lookup(self.input)
        self.hits.index_add_(0, self.winners, torch.ones_like(self.winners))

    def numpy_run(self) -> None:
        n = self.input.shape[0]
        x = as_numpy(self.input).reshape(n, -1).astype(np.float32)
        d = self.distances(np, x, self.np_param("weights"))
        win = d.argmin(axis=1)
        self.winners = win.astype(np.int32)
        self.output = stored_f32(d[np.arange(n), win])
        np.add.at(as_numpy(self.hits), win, 1)


class KohonenTrainer(ModuleUnit):
    """The batch SOM update (the reference's ``KohonenTrainer``).  Links:
    ``input``, the forward's ``weights`` and ``winners``, and
    ``forward_mode`` (from the loader; part of the region's key: eval
    minibatches leave the map alone).  ``shape_grid`` is the forward's
    grid."""

    WRITES = ()

    def __init__(self, workflow=None, name: str | None = None,
                 learning_rate: float = 0.5, sigma0: float | None = None,
                 sigma_inf: float = 0.5, decay_steps: int = 1000,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.learning_rate = learning_rate
        self.sigma0 = sigma0          # default: half the grid's longer side
        self.sigma_inf = sigma_inf
        self.decay_steps = int(decay_steps)
        self.forward_mode = "train"   # usually linked from the loader
        self.shape_grid: tuple[int, int] | None = None
        #: the decay clock: steps taken (a 0-d f32 tensor)
        self.register_buffer("time", None)
        self.register_buffer("_coords", None)

    def region_key(self) -> tuple:
        return (self.forward_mode,)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        w = self.weights                  # AttributeError: defer
        if self.shape_grid is None:
            raise ValueError(f"{self}: shape_grid not set (assign the "
                             f"paired KohonenForward's grid shape)")
        sy, sx = self.shape_grid
        if self.sigma0 is None:
            self.sigma0 = max(sy, sx) / 2.0
        self._coords = torch.from_numpy(grid_coords(sy, sx)).to(w.device)
        if self.time is None:
            self.time = torch.zeros((), dtype=torch.float32)
        self.time = self.time.to(w.device)

    def written_values(self) -> list[tuple[str, object]]:
        enc = self._linked_attrs["weights"].source \
            if "weights" in self._linked_attrs else self
        return [(f"{enc.name}.weights", self.weights), ("time", self.time)]

    # -- the decayed schedule ---------------------------------------------
    def _schedule(self, xp, t):
        if xp is torch:
            frac = torch.clamp(t / float(self.decay_steps), max=1.0)
        else:
            frac = xp.minimum(t / float(self.decay_steps), 1.0)
        sigma = self.sigma0 * (self.sigma_inf / self.sigma0) ** frac
        lr = self.learning_rate * (0.01) ** frac
        return sigma, lr

    def _update(self, xp, x, w, win, coords, t):
        sigma, lr = self._schedule(xp, t)
        n = x.shape[0]
        winc = coords[win]                       # (n, 2)
        d2 = ((winc[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
        h = xp.exp(-d2 / (2.0 * sigma * sigma))  # (n, n_neurons)
        num = h.T @ x                            # (n_neurons, features)
        den = h.sum(axis=0)[:, None]             # (n_neurons, 1)
        return w + lr / n * (num - den * w)

    @torch.no_grad()
    def device_run(self) -> None:
        if self.forward_mode != "train":
            return
        x = self.input
        n = x.shape[0]
        w = self.weights
        w.copy_(self._update(torch, x.reshape(n, -1).float(), w,
                             self.winners.long(), self._coords, self.time))
        self.time.add_(1.0)

    def numpy_run(self) -> None:
        if self.forward_mode != "train":
            return
        n = self.input.shape[0]
        x = as_numpy(self.input).reshape(n, -1).astype(np.float32)
        w = as_numpy(self.weights)
        t = as_numpy(self.time)
        w[...] = self._update(np, x, w, as_numpy(self.winners),
                              as_numpy(self._coords), float(t))
        t[...] += 1.0


def init_som_weights(shape: tuple[int, int], features: int,
                     scale: float = 1.0) -> np.ndarray:
    """A seeded uniform fill for samples and tests (the default
    generator's host stream, as in the reference)."""
    gen = prng.get()
    return gen.fill_uniform((shape[0] * shape[1], features),
                            -scale, scale, dtype=np.float32)
