"""NN-specific plotters (port of ``znicz_tpu/ops/nn_plotting_units.py``):
weights as images (``Weights2D``), the SOM's hit map (``KohonenHits``)
and the per-sample squared error's histogram (``MSEHistogram``).

Each is a host :class:`~znicz_tpu_torch.plotting_units.Plotter`: it
reads the layer's weights, the SOM's ``hits`` or the net's output back
from the device (:func:`~znicz_tpu_torch.plotting_units.host_value`)
when it fires, after the training step's graph, and writes nothing the
graph reads.  :func:`tile_filters` is the reference's, copied (numpy
only).
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.plotting_units import Plotter, host_value


def tile_filters(weights: np.ndarray, sample_shape=None,
                 max_tiles: int = 64) -> np.ndarray:
    """Arrange per-output-unit weight rows as a grid of 2-D tiles.

    ``weights`` is ``(in_features, out_features)`` (this framework's
    layout) — each column is one unit's receptive field, reshaped to
    ``sample_shape`` (H×W or H×W×C; inferred square if omitted).
    """
    w = np.asarray(weights)
    if w.ndim == 4:  # conv (kx, ky, c_in, n_kernels) → tile per kernel
        kx, ky, c_in, n_k = w.shape
        cols = w.reshape(kx * ky * c_in, n_k)
        sample_shape = (kx, ky, c_in)
        w = cols
    n_in, n_out = w.shape
    if sample_shape is None:
        side = int(np.sqrt(n_in))
        if side * side != n_in:
            side = 1
        sample_shape = (side, max(1, n_in // side))
    n = min(n_out, max_tiles)
    grid = int(np.ceil(np.sqrt(n)))
    h, wd = sample_shape[0], sample_shape[1]
    channels = sample_shape[2] if len(sample_shape) > 2 else 1
    canvas = np.zeros((grid * (h + 1) + 1, grid * (wd + 1) + 1, channels),
                      dtype=np.float32)
    for i in range(n):
        tile = w[:, i].reshape(h, wd, channels)
        lo, hi = tile.min(), tile.max()
        if hi > lo:
            tile = (tile - lo) / (hi - lo)
        r, c = divmod(i, grid)
        canvas[1 + r * (h + 1):1 + r * (h + 1) + h,
               1 + c * (wd + 1):1 + c * (wd + 1) + wd] = tile
    if channels == 1:
        return canvas[..., 0]
    if channels == 3:
        return canvas
    # imshow can only draw 1/3/4-channel images — collapse the rest
    return canvas.mean(axis=-1)


class Weights2D(Plotter):
    """Renders a layer's weight columns as a tiled image ("filters as
    pictures")."""

    def __init__(self, workflow, name: str | None = None,
                 sample_shape=None, max_tiles: int = 64, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.input = None  # link to a layer's weights
        self.sample_shape = sample_shape
        self.max_tiles = max_tiles

    def make_payload(self) -> dict | None:
        w = host_value(self.input)
        if w is None:
            return None
        img = tile_filters(w, self.sample_shape, self.max_tiles)
        return {"kind": "image", "data": img, "cmap": "gray",
                "title": f"{self.name} ({tuple(w.shape)})"}


class KohonenHits(Plotter):
    """The SOM's winner-hit map as a heatmap over the neuron grid."""

    def __init__(self, workflow, name: str | None = None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.input = None   # KohonenForward.hits
        self.shape_grid: tuple[int, int] | None = None

    def make_payload(self) -> dict | None:
        hits = host_value(self.input)
        if hits is None or self.shape_grid is None:
            return None
        sy, sx = self.shape_grid
        return {"kind": "matrix", "data": hits.reshape(sy, sx),
                "cmap": "hot", "title": f"{self.name} hits"}


class MSEHistogram(Plotter):
    """Histogram of the per-sample squared error of the last
    minibatch."""

    def __init__(self, workflow, name: str | None = None,
                 n_bins: int = 20, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.output = None   # the net's output
        self.target = None   # the ground truth
        self.n_bins = n_bins

    def make_payload(self) -> dict | None:
        y = host_value(self.output)
        t = host_value(self.target)
        if y is None or t is None:
            return None
        y = np.asarray(y, dtype=np.float32)
        t = np.asarray(t, dtype=np.float32).reshape(y.shape)
        per_sample = ((y - t) ** 2).reshape(y.shape[0], -1).sum(axis=1)
        counts, edges = np.histogram(per_sample, bins=self.n_bins)
        centers = 0.5 * (edges[:-1] + edges[1:])
        return {"kind": "hist", "data": counts, "bin_centers": centers,
                "bar_width": float(edges[1] - edges[0]) * 0.9,
                "ylabel": "samples", "title": f"{self.name} mse"}
