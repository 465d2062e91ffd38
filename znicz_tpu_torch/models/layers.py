"""Layer-type registry (counterpart of
``znicz_tpu/models/standard_workflow.layer_type``).

Maps a bundle manifest's (or a workflow's) layer ``type`` name to the
port unit that computes it; :func:`znicz_tpu_torch.ops.nn_units.gd_for`
then gives its backward unit.  A type the reference knows but the port
has not ported yet raises, naming itself, so a bundle the port cannot
serve fails when it loads rather than serving something else.
"""

from __future__ import annotations

from znicz_tpu_torch.ops import all2all, attention, layer_norm
from znicz_tpu_torch.ops import gd  # noqa: F401 — registers the pairs

_LAYER_TYPES: dict[str, type] = {
    "all2all": all2all.All2All,
    "softmax": all2all.All2AllSoftmax,
    "attention": attention.MultiHeadAttention,
    "layer_norm": layer_norm.LayerNorm,
}


def layer_type(name: str) -> type:
    """The port unit class for manifest layer type ``name``."""
    try:
        return _LAYER_TYPES[name]
    except KeyError:
        raise ValueError(f"layer type '{name}' is not ported yet (ported: "
                         f"{sorted(_LAYER_TYPES)})") from None
