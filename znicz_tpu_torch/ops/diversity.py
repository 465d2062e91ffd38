"""Filter-similarity diagnostics (port of ``znicz_tpu/ops/diversity.py``):
how alike a layer's learned filters are, to spot wasted capacity
(near-duplicate filters mean the layer has fewer features than
weights).

The pairwise similarity is one normalized Gram matrix, ``U @ Uᵀ`` over
the unit-normalized, centered filter rows: with ``xp=np`` (the default)
in numpy on any weights layout, with ``xp=torch`` one product on the
tensor's device (2-D filter rows, as the reference's ``xp=jnp`` path
takes them).  Grouping near-duplicates is a small union-find on the
host over the (n_filters × n_filters) matrix.
:class:`FilterDiversityReporter` logs each layer's diversity when the
decision reports an improved epoch, its Gram product on the weights'
device.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.units import Unit


def _as_filter_rows(weights) -> np.ndarray:
    """(…, n_filters) conv kernels or (n_in, n_out) FC weights →
    (n_filters, fan_in) rows.

    Conv weights are HWIO (ky, kx, c_in, n_kernels), as the conv units
    train them, and FC weights (in, out): in both the last axis indexes
    the filters.
    """
    arr = np.asarray(weights, dtype=np.float32)
    if arr.ndim < 2:
        raise ValueError(f"weights must be ≥2-D, got {arr.shape}")
    return arr.reshape(-1, arr.shape[-1]).T


def filter_rows(weights: torch.Tensor) -> torch.Tensor:
    """:func:`_as_filter_rows` of a tensor, on its device, in f32."""
    if weights.dim() < 2:
        raise ValueError(f"weights must be ≥2-D, got {tuple(weights.shape)}")
    return weights.detach().float().reshape(-1, weights.shape[-1]).T


def filter_similarity(weights, xp=np):
    """The pairwise Pearson correlation of a layer's filters: an
    (n_filters, n_filters) symmetric matrix with a unit diagonal.
    ``xp=torch`` computes it on the device of ``weights``, 2-D filter
    rows (:func:`filter_rows`), in one product; the default is the
    numpy oracle on any weights layout."""
    if xp is torch:
        rows = weights
        centered = rows - rows.mean(dim=1, keepdim=True)
        norms = torch.sqrt((centered ** 2).sum(dim=1, keepdim=True))
        unit = centered / torch.clamp(norms, min=1e-12)
        return unit @ unit.T
    rows = _as_filter_rows(weights)
    centered = rows - rows.mean(axis=1, keepdims=True)
    norms = np.sqrt((centered ** 2).sum(axis=1, keepdims=True))
    unit = centered / np.maximum(norms, 1e-12)
    return np.dot(unit, unit.T)


def groups_of(sim: np.ndarray, threshold: float) -> list[list[int]]:
    """The connected components of the |similarity| ≥ threshold graph,
    singletons dropped, largest first."""
    n = sim.shape[0]
    parent = list(range(n))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if abs(sim[i, j]) >= threshold:
                parent[find(i)] = find(j)
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return sorted((g for g in groups.values() if len(g) > 1),
                  key=lambda g: (-len(g), g[0]))


def similar_kernel_groups(weights, threshold: float = 0.85
                          ) -> list[list[int]]:
    """Groups of near-duplicate filters (the reference's semantics: only
    the redundant clusters are reported)."""
    return groups_of(filter_similarity(weights), threshold)


def diversity_score(weights, threshold: float = 0.85,
                    groups: list[list[int]] | None = None) -> float:
    """The fraction of filters in no near-duplicate group: 1.0 when
    every filter is distinct, 0.0 at total redundancy.  Precomputed
    ``groups`` skip the similarity matrix."""
    n = int(np.shape(weights)[-1])
    if n == 0:
        return 1.0
    if groups is None:
        groups = similar_kernel_groups(weights, threshold)
    redundant = sum(len(g) for g in groups)
    return 1.0 - redundant / n


class FilterDiversityReporter(Unit):
    """Logs each layer's filter diversity when the decision reports an
    improved validation epoch (the hook the reference's diversity
    plotters used)::

        rep = FilterDiversityReporter(wf)
        rep.weights_list = [fwd.weights for fwd in wf.forwards[:-1]]
        rep.link_from(wf.decision)
        rep.gate_skip = Bool._derived(lambda: not wf.decision.improved)

    ``weights_list`` holds tensors (the forwards' parameters, whose
    Gram products run on their device) or Vectors.
    """

    def __init__(self, workflow=None, name: str | None = None,
                 threshold: float = 0.85, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.threshold = float(threshold)
        self.weights_list: list = []
        #: the last report, {layer name: (score, duplicate groups)}
        self.last_report: dict[str, tuple[float, int]] = {}

    def run(self) -> None:
        self.last_report = {}
        for i, value in enumerate(self.weights_list):
            if isinstance(value, Vector):
                if not value:
                    continue
                value.map_read()
                label = value.name
                sim = filter_similarity(np.array(value.mem))
                n = value.shape[-1]
            elif isinstance(value, torch.Tensor):
                label = f"weights{i}"
                sim = filter_similarity(filter_rows(value), xp=torch)
                sim = sim.cpu().numpy()
                n = value.shape[-1]
            else:
                continue
            groups = groups_of(sim, self.threshold)
            score = 1.0 - sum(len(g) for g in groups) / n if n else 1.0
            self.last_report[label] = (score, len(groups))
            self.info("%s: diversity %.3f (%d duplicate groups)",
                      label, score, len(groups))
