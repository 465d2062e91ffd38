"""Token embedding (port of ``znicz_tpu/ops/embedding.py``).

``y[b, t] = W[tokens[b, t]]`` with a learned (V, D) f32 table, filled
gaussian at stddev 0.02, no bias.  Token ids ride the loader's float
minibatch path unchanged; the unit rounds them to indices and clips
them into the vocabulary (an out-of-vocabulary id takes the last row).
The input storage must hold every id exactly, so a vocabulary past what
it holds is refused (bf16 holds the integers up to 256).

The backward, ``GDEmbedding``, is the gather's adjoint: the (B·T, D)
error rows added into a (V, D) f32 gradient at their tokens, then the
shared update.  It is the first trainable layer of its chain: token ids
have no gradient, so it has no ``err_input`` and refuses to be asked for
one.

The scatter-add is deterministic on every device, so a rerun and a
replayed CUDA graph give the same bits, and it adds each token's rows in
the order they occur, as ``np.add.at`` does.  On the card it is
``index_put_`` with ``accumulate=True``, which sorts the token ids (a
stable radix sort) and adds each run of equal ids in order, one thread
a column, with no atomics (``index_add_`` there adds with atomics, in
another order from run to run).  On the CPU it is ``index_add_``, which
adds the rows one after the other (``index_put_`` there splits the sum
across threads).

The decode gather (``xla_embed``) belongs to the decode slice.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import Forward, GradientDescentBase

#: the largest integer each storage width holds exactly, by bytes
_MAX_EXACT = {2: 256, 4: 2 ** 24, 8: 2 ** 53}


class Embedding(Forward):
    """Learned lookup table: int-valued (B, T) input → (B, T, D)."""

    EXPORT_PARAMS = ("weights",)
    WEIGHTS_FILLING = "gaussian"

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 vocab_size: int | None = None, dim: int | None = None,
                 include_bias: bool = False, **kwargs) -> None:
        if vocab_size is None or dim is None:
            raise ValueError("embedding needs vocab_size and dim")
        kwargs.setdefault("weights_stddev", 0.02)
        super().__init__(input_shape, compute_dtype,
                         include_bias=include_bias, **kwargs)
        if self.include_bias:
            raise ValueError("embedding has no bias")
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        if self.input_shape is not None:
            self.check_input_shape()

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 1:
            raise ValueError(f"embedding expects (time,) token samples, "
                             f"got {self.input_shape}")
        # the ids are stored at the activation dtype (the loader's batch,
        # a request rounded to the bundle's dtype)
        store = self.act_store_dtype
        max_exact = _MAX_EXACT.get(store.itemsize, 2 ** 24)
        if self.vocab_size - 1 > max_exact:
            raise ValueError(
                f"embedding: vocab_size {self.vocab_size} exceeds the "
                f"largest integer the input storage dtype {store} "
                f"represents exactly ({max_exact}): train in float32 or "
                f"use a smaller vocabulary")

    @property
    def output_shape(self) -> tuple:
        return self.input_shape + (self.dim,)

    def param_shapes(self) -> dict[str, tuple]:
        return {"weights": (self.vocab_size, self.dim)}

    def initial_params(self) -> dict[str, np.ndarray]:
        return {"weights": self.fill_array(
            (self.vocab_size, self.dim), self.weights_filling,
            self.weights_stddev, fan_in=self.dim)}

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Float ids → table indices: rounded half to even, then clipped
        into the vocabulary."""
        return torch.round(x.float()).long().clamp_(0, self.vocab_size - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weights[self.tokens(x)].to(self.output_store_dtype)


class GDEmbedding(GradientDescentBase):
    """Embedding backward: the error rows added into the table's
    gradient at their tokens, in a deterministic order."""

    MATCHES = (Embedding,)
    NEEDS_AUTOGRAD = False

    def __init__(self, forward_unit: Embedding, *args,
                 need_err_input: bool = False, **kwargs) -> None:
        if need_err_input:
            # a layer before an embedding would train on zeros
            raise ValueError(
                "embedding must be the first trainable layer "
                "(need_err_input=True was requested but token ids have "
                "no gradient)")
        super().__init__(forward_unit, *args, need_err_input=False,
                         **kwargs)

    @torch.no_grad()
    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        tokens = fwd.tokens(x).reshape(-1)
        err = err_output.float().reshape(tokens.shape[0], -1)
        grad = torch.zeros(fwd.weights.shape, dtype=torch.float32,
                           device=err.device)
        if grad.device.type == "cpu":
            grad.index_add_(0, tokens, err)
        else:
            grad.index_put_((tokens,), err, accumulate=True)
        self.apply_weights(grad)
        return None
