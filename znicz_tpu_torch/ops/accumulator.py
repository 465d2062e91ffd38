"""Signal accumulators: running histograms and ranges for diagnostics
(port of ``znicz_tpu/ops/accumulator.py``): ``FixAccumulator`` over a
fixed bin range, ``RangeAccumulator`` over the range observed so far.

Host units, copied from the reference: each reads its ``input`` (a
tensor, read back to the host, a :class:`~znicz_tpu_torch.memory.Vector`
or an array) between steps, on a side chain or once an epoch, and keeps
an int64 numpy histogram (a Vector) that plotters or the metrics stream
can read.
"""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.ops.nn_units import to_host
from znicz_tpu_torch.units import Unit


class FixAccumulator(Unit):
    """Histogram over a fixed ``[lo, hi]`` range with ``n_bins`` bins;
    values out of the range fall into the edge bins."""

    SNAPSHOT_ATTRS = ("n_observed",)

    def __init__(self, workflow=None, name: str | None = None,
                 lo: float = 0.0, hi: float = 1.0, n_bins: int = 30,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.input = None
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_bins = int(n_bins)
        self.histogram = Vector(
            np.zeros(self.n_bins, dtype=np.int64),
            name=f"{self.name}.histogram")
        self.n_observed = 0

    @property
    def bin_centers(self) -> np.ndarray:
        edges = np.linspace(self.lo, self.hi, self.n_bins + 1)
        return 0.5 * (edges[:-1] + edges[1:])

    def reset(self) -> None:
        self.histogram.mem[...] = 0
        self.n_observed = 0

    def observe(self, values: np.ndarray) -> None:
        v = np.clip(np.asarray(values, dtype=np.float64).ravel(),
                    self.lo, self.hi)
        counts, _ = np.histogram(v, bins=self.n_bins,
                                 range=(self.lo, self.hi))
        self.histogram.mem += counts
        self.n_observed += v.size

    def run(self) -> None:
        if self.input is not None:
            self.observe(to_host(self.input))


class RangeAccumulator(Unit):
    """The running min and max of a signal, and a histogram over the
    range seen so far (rebinned as the range grows)."""

    SNAPSHOT_ATTRS = ("x_min", "x_max", "n_observed")

    def __init__(self, workflow=None, name: str | None = None,
                 n_bins: int = 30, max_retained: int = 1 << 20,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.input = None
        self.n_bins = int(n_bins)
        self.x_min = np.inf
        self.x_max = -np.inf
        self.n_observed = 0
        self.histogram = Vector(
            np.zeros(self.n_bins, dtype=np.int64),
            name=f"{self.name}.histogram")
        #: the buffer of the exact rebin, bounded: once more than
        #: ``max_retained`` values have been seen, retention stops and
        #: a later growth of the range rebins approximately, by the old
        #: bins' centers
        self.max_retained = int(max_retained)
        self._samples: list[np.ndarray] | None = []
        self._retained = 0

    @property
    def bin_centers(self) -> np.ndarray:
        lo = self.x_min if np.isfinite(self.x_min) else 0.0
        hi = self.x_max if np.isfinite(self.x_max) else 1.0
        edges = np.linspace(lo, hi, self.n_bins + 1)
        return 0.5 * (edges[:-1] + edges[1:])

    def reset(self) -> None:
        self.x_min, self.x_max = np.inf, -np.inf
        self.n_observed = 0
        self.histogram.mem[...] = 0
        self._samples = []
        self._retained = 0

    def observe(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        lo, hi = float(v.min()), float(v.max())
        grew = lo < self.x_min or hi > self.x_max
        old_min, old_max = self.x_min, self.x_max
        self.x_min = min(self.x_min, lo)
        self.x_max = max(self.x_max, hi)
        if self._samples is not None:
            self._samples.append(v)
            self._retained += v.size
        self.n_observed += v.size
        if grew:  # rebin everything over the widened range
            if self._samples is not None:  # exact
                self.histogram.mem[...] = 0
                for s in self._samples:
                    self._bin(s)
            else:  # approximate: the old counts by their bins' centers
                self._rebin_approx(old_min, old_max)
                self._bin(v)
        else:
            self._bin(v)
        if self._samples is not None and self._retained > self.max_retained:
            self._samples = None  # the memory bound is reached

    def _rebin_approx(self, old_min: float, old_max: float) -> None:
        counts = np.array(self.histogram.mem, copy=True)
        self.histogram.mem[...] = 0
        if not np.isfinite(old_min) or counts.sum() == 0:
            return
        old_hi = old_max if old_max > old_min else old_min + 1.0
        edges = np.linspace(old_min, old_hi, self.n_bins + 1)
        centers = 0.5 * (edges[:-1] + edges[1:])
        new_hi = (self.x_max if self.x_max > self.x_min
                  else self.x_min + 1.0)
        idx = np.clip(((centers - self.x_min) / (new_hi - self.x_min)
                       * self.n_bins).astype(np.int64), 0, self.n_bins - 1)
        np.add.at(self.histogram.mem, idx, counts)

    def _bin(self, v: np.ndarray) -> None:
        hi = self.x_max if self.x_max > self.x_min else self.x_min + 1.0
        counts, _ = np.histogram(v, bins=self.n_bins,
                                 range=(self.x_min, hi))
        self.histogram.mem += counts

    def run(self) -> None:
        if self.input is not None:
            self.observe(to_host(self.input))
