"""Layer-type registry (counterpart of
``znicz_tpu/models/standard_workflow.layer_type``).

Maps a bundle manifest's (or a workflow's) layer ``type`` name to the
port unit that computes it; :func:`znicz_tpu_torch.ops.nn_units.gd_for`
then gives its backward unit.  A type the reference knows but the port
has not ported yet raises, naming itself, so a bundle the port cannot
serve fails when it loads rather than serving something else.

:func:`tie` is a layer's ``tied_to``: a decoder layer paired with the
encoder layer it inverts, in a workflow and in a bundle's chain alike.
"""

from __future__ import annotations

from znicz_tpu_torch.ops import (activation, all2all, attention, conv,
                                 cutter, deconv, depooling, dropout,
                                 embedding, layer_norm, lstm, normalization,
                                 pooling, pos_encoding, seq_reshape)
# the backward units register their pairs when imported
from znicz_tpu_torch.ops import gd, gd_conv, gd_deconv  # noqa: F401
from znicz_tpu_torch.ops import gd_pooling  # noqa: F401

_LAYER_TYPES: dict[str, type] = {
    "all2all": all2all.All2All,
    "all2all_tanh": all2all.All2AllTanh,
    "all2all_relu": all2all.All2AllRELU,
    "all2all_str": all2all.All2AllStrictRELU,
    "all2all_sigmoid": all2all.All2AllSigmoid,
    "softmax": all2all.All2AllSoftmax,
    "conv": conv.Conv,
    "conv_tanh": conv.ConvTanh,
    "conv_relu": conv.ConvRELU,
    "conv_str": conv.ConvStrictRELU,
    "conv_sigmoid": conv.ConvSigmoid,
    "max_pooling": pooling.MaxPooling,
    "maxabs_pooling": pooling.MaxAbsPooling,
    "avg_pooling": pooling.AvgPooling,
    "stochastic_pooling": pooling.StochasticPooling,
    "norm": normalization.LRNormalizerForward,
    "cutter": cutter.Cutter,
    "dropout": dropout.DropoutForward,
    "activation_tanh": activation.ForwardTanh,
    "activation_relu": activation.ForwardRELU,
    "activation_str": activation.ForwardStrictRELU,
    "activation_sigmoid": activation.ForwardSigmoid,
    "activation_log": activation.ForwardLog,
    "activation_mul": activation.ForwardMul,
    "deconv": deconv.Deconv,
    "deconv_tanh": deconv.DeconvTanh,
    "deconv_relu": deconv.DeconvRELU,
    "deconv_sigmoid": deconv.DeconvSigmoid,
    "depooling": depooling.Depooling,
    "attention": attention.MultiHeadAttention,
    "layer_norm": layer_norm.LayerNorm,
    "embedding": embedding.Embedding,
    "pos_encoding": pos_encoding.PositionalEncoding,
    "to_sequence": seq_reshape.ToSequence,
    "last_token": seq_reshape.LastToken,
    "lstm": lstm.LSTM,
}


def layer_type(name: str) -> type:
    """The port unit class for manifest layer type ``name``."""
    try:
        return _LAYER_TYPES[name]
    except KeyError:
        raise ValueError(f"layer type '{name}' is not ported yet (ported: "
                         f"{sorted(_LAYER_TYPES)})") from None


#: the constructor geometry a tied deconv takes from its conv, unless its
#: own config sets it
TIED_GEOMETRY = ("n_kernels", "kx", "ky", "sliding", "padding")


def tied_config(cls: type, config: dict, tied: dict) -> dict:
    """A layer's constructor config with a tied deconv's geometry filled
    in from the config of the conv it is tied to (``tied``)."""
    cfg = dict(config)
    if issubclass(cls, deconv.Deconv):
        for key in TIED_GEOMETRY:
            if key in tied:
                cfg.setdefault(key, tied[key])
    return cfg


def tie(unit, tied_unit, type_name: str, tied_weights: bool) -> None:
    """Pair ``unit`` with the earlier ``tied_unit`` (the reference's
    ``tied_to``): a deconv takes its conv's input shape and, with
    ``tied_weights``, the conv's weights tensor; a depooling takes its
    pooling.  Any other layer type raises, as in the reference."""
    if isinstance(unit, deconv.Deconv):
        unit.tie(tied_unit, weights=bool(tied_weights))
    elif isinstance(unit, depooling.Depooling):
        unit.tie(tied_unit)
    else:
        raise ValueError(f"layer type '{type_name}' does not support "
                         f"tied_to")
