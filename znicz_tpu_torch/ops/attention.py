"""Multi-head attention unit and its backward (port of
``znicz_tpu/ops/attention.py``).

``MultiHeadAttention`` maps (B, T, D) → (B, T, D) as the reference's
``xla_forward`` does:

.. code-block:: text

    qkv  = x @ W_qkv + b_qkv          (D, 3·D) packed projection
    q,k,v split → (B, T, H, D/H)
    o    = softmax(q·kᵀ/√dₕ [+causal]) · v     the flash kernel
    y    = concat(o) @ W_out + b_out   (D, D)

In bf16 mode the projections take bf16 operands with f32 results, the
q/k/v slices are stored in bf16 once before the core (the kernel's
operand dtype), and ``y`` is stored in bf16.  The core is
:func:`~znicz_tpu_torch.ops.flash_attention.attention_core`, routed as
the reference routes it: the flash kernels (bf16 or f32, on the card;
their plain versions on the CPU) when the head dim is a multiple of 8,
else the plain attention core on every device.  The q/k/v slices reach
it as strided views of the projection, with no copy.

Backward: ``GDMultiHeadAttention`` takes ``torch.autograd.grad`` of the
output the forward kept on the train step, with respect to ``(x,
W_qkv, b_qkv, W_out, b_out)`` — the counterpart of the reference's
stashed ``jax.vjp`` pullback, so the forward never runs twice.  The
core's gradient is the flash backward kernels (through
:class:`~znicz_tpu_torch.ops.flash_attention.FlashHop`), or autograd of
the plain core where the head dim routes there.  Autograd
rounds each cotangent to bf16 where the forward cast to bf16, as
``jax.vjp`` does at the same casts, so the forward's chain of casts
here must stay the reference's.

On the numpy oracle the pair runs the reference's numpy path: the
projections and the core with ``np.einsum`` (:func:`local_attention_np`),
and the analytic backward written out.

Decode (:mod:`znicz_tpu_torch.serving.decode`) has its own entry points,
the reference's, in plain f32 products and gathers whatever the
bundle's dtype (the reference's einsums: a decode step's products are
(B, 1, ·) slivers where the flash kernel's tiling has nothing to win):

- the flat forms: :meth:`MultiHeadAttention.prefill`, the causal
  forward that also gives every position's K and V, and
  :meth:`MultiHeadAttention.decode_step`, one token a lane over its own
  (Tmax, H, Dh) rows, returned updated (a functional update of the rows
  the decoder gathered, which it writes back itself);
- the paged forms over a shared pool of pages addressed through block
  tables (the last entry of a table is the trash page):
  :meth:`MultiHeadAttention.prefill_paged`,
  :meth:`MultiHeadAttention.decode_step_paged` and
  :meth:`MultiHeadAttention.window_paged`, with optional int8 pools and
  their f32 scale pools.  These write the pools they are given IN PLACE
  (``index_put_``) and return them, the same tensors: the decoder's
  pools live outside any CUDA graph's memory pool, and a functional
  update would leave the graph writing a copy.  Dead lanes, padded
  positions and positions past a table write into the trash page, so
  every scatter and gather index stays inside the pool.

``seq_parallel=True`` on a device whose mesh has a ``seq`` (else
``model``) axis of 2 or more runs the ring (the reference's
``sequence_sharded_attention``): each process projects q, k and v for
its block of time, the blocks meet around the ring
(:mod:`znicz_tpu_torch.parallel.ring_attention`, the flash kernels a
hop), the output projection runs on the block, and the blocks are
all-gathered along time, so every unit after the attention sees the
whole sequence.  The backward sums the parameter gradients and
``err_input`` (each process's covers its block of time) over the ring's
axis.  Without such an axis the option changes nothing, so a bundle
trained with ``seq_parallel`` or ``flash_block_k`` serves here all the
same: both are layout choices with identical math.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.flash_attention import attention_core
from znicz_tpu_torch.ops.nn_units import Forward, GradientDescentBase
from znicz_tpu_torch.parallel import ring_attention
from znicz_tpu_torch.parallel.axis import all_reduce


def split_heads(qkv: torch.Tensor, n_heads: int):
    """(B, T, 3D) → three (B, T, H, D/H) views (slicing and reshape
    only)."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    shape = (b, t, n_heads, d // n_heads)
    return (qkv[..., :d].view(shape), qkv[..., d:2 * d].view(shape),
            qkv[..., 2 * d:].view(shape))


def local_attention_np(q, k, v, causal: bool):
    """The oracle's attention core (the reference's
    ``_local_attention_np``, copied): ``(o, p)`` from (B, T, H, Dh)
    q, k, v."""
    d = q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = np.arange(tq)[:, None] >= np.arange(tk)[None, :]
        s = np.where(mask[None, None], s, -1e30)
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(axis=-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", p, v)
    return o, p


class MultiHeadAttention(Forward):
    """Weighted multi-head self-attention layer."""

    EXPORT_PARAMS = ("weights", "bias", "weights_out", "bias_out")
    #: fan-scaled initial fill, as the reference's attention defaults to
    WEIGHTS_FILLING = "xavier"

    def __init__(self, input_shape=None, compute_dtype: torch.dtype
                 | None = None, n_heads: int = 1, causal: bool = False,
                 seq_parallel: bool = False,
                 flash_block_k: int | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.n_heads = int(n_heads)
        self.causal = bool(causal)
        #: set by the backward unit: keep the autograd graph of a call
        #: made with gradients enabled, and whether ``x``'s gradient is
        #: wanted too
        self.keep_graph = False
        self.input_grad = False
        #: ``(x, f32 output)`` of the last call that kept its graph
        self.stash: tuple | None = None
        self.seq_parallel = bool(seq_parallel)
        if self.input_shape is not None:
            self.check_input_shape()

    @property
    def ring(self):
        """The :class:`~znicz_tpu_torch.parallel.ring_attention.ProcessRing`
        of ``seq_parallel`` over the mesh's ring axis, or None."""
        if not self.seq_parallel or self.device is None:
            return None
        axis = ring_attention.ring_axis(self.device.mesh)
        if axis is None:
            return None
        ring = self.__dict__.get("_ring")
        if ring is None:
            ring = self.__dict__["_ring"] = ring_attention.ProcessRing(
                self.device.group(axis))
        return ring

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 2:
            raise ValueError(f"attention expects (time, features) "
                             f"samples, got {self.input_shape}")
        d = self.input_shape[1]
        if d % self.n_heads:
            raise ValueError(f"features {d} not divisible by "
                             f"{self.n_heads} heads")

    def param_shapes(self) -> dict[str, tuple]:
        d = self.input_shape[1]
        shapes = {"weights": (d, 3 * d), "weights_out": (d, d)}
        if self.include_bias:
            shapes.update(bias=(3 * d,), bias_out=(d,))
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        d = self.input_shape[1]
        params = {
            "weights": self.fill_array((d, 3 * d), self.weights_filling,
                                       self.weights_stddev, fan_in=d),
            "weights_out": self.fill_array((d, d), self.weights_filling,
                                           self.weights_stddev, fan_in=d)}
        if self.include_bias:
            params.update(bias=np.zeros(3 * d, np.float32),
                          bias_out=np.zeros(d, np.float32))
        return params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.keep_graph and torch.is_grad_enabled()):
            return self.core(x).to(self.output_store_dtype)
        x = x.detach().requires_grad_(self.input_grad)
        y = self.core(x)
        self.stash = (x, y)
        return y.detach().to(self.output_store_dtype)

    def core(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 output (B, T, D) before its storage cast — what the
        reference's ``xla_forward`` returns and differentiates."""
        ring = self.ring
        if ring is not None:
            return self._ring_core(x, ring)
        b, t, d = x.shape
        qkv = self.mxu_dot(x.float().reshape(b * t, d), self.weights)
        if self.include_bias:
            qkv = qkv + self.bias
        dot_dtype = self.mxu_dtype
        if dot_dtype is not None:
            qkv = qkv.to(dot_dtype)
        q, k, v = split_heads(qkv.reshape(b, t, 3 * d), self.n_heads)
        o = attention_core(q, k, v, causal=self.causal, dot_dtype=dot_dtype)
        y = self.mxu_dot(o.reshape(b * t, d), self.weights_out)
        if self.include_bias:
            y = y + self.bias_out
        return y.reshape(b, t, d)

    def _ring_core(self, x: torch.Tensor, ring) -> torch.Tensor:
        """:meth:`core` with time split over ``ring``: this process's
        block of x projected, the ring, the output projection of the
        block, the blocks all-gathered along time."""
        b, t, d = x.shape
        if t % ring.n:
            raise ValueError(f"{self.name}: sequence of {t} does not split "
                             f"over a ring of {ring.n}")
        tl = t // ring.n
        xl = x[:, ring.rank * tl:(ring.rank + 1) * tl]
        qkv = self.mxu_dot(xl.float().reshape(b * tl, d), self.weights)
        if self.include_bias:
            qkv = qkv + self.bias
        dot_dtype = self.mxu_dtype
        if dot_dtype is not None:
            qkv = qkv.to(dot_dtype)
        q, k, v = split_heads(qkv.reshape(b, tl, 3 * d), self.n_heads)
        o = ring_attention.sequence_sharded_attention(
            ring, q, k, v, causal=self.causal, dot_dtype=dot_dtype)
        y = self.mxu_dot(o.reshape(b * tl, d), self.weights_out)
        if self.include_bias:
            y = y + self.bias_out
        return ring_attention.gather_time(y.reshape(b, tl, d), ring)

    def forward_np(self, x: np.ndarray):
        """The oracle's forward: ``(y, (qkv, q, k, v, o, p))``."""
        b, t, d = x.shape
        qkv = x.reshape(b * t, d) @ self.np_param("weights")
        if self.include_bias:
            qkv = qkv + self.np_param("bias")
        shape = (b, t, self.n_heads, d // self.n_heads)
        q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(shape)
                   for i in range(3))
        o, p = local_attention_np(q, k, v, self.causal)
        y = o.reshape(b * t, d) @ self.np_param("weights_out")
        if self.include_bias:
            y = y + self.np_param("bias_out")
        return y.reshape(b, t, d), (qkv, q, k, v, o, p)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        return self.forward_np(x.astype(np.float32))[0]

    # -- decode ---------------------------------------------------------
    def _scores(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, Q, H, Dh) × (B, K, H, Dh) → (B, H, Q, K) over √dₕ (the
        divisor the f32 value of the reference's ``jnp.sqrt``)."""
        root = float(np.sqrt(np.float32(q.shape[-1])))
        return torch.einsum("bqhd,bkhd->bhqk", q, k) / root

    @staticmethod
    def _softmax_av(s: torch.Tensor, mask: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
        """The masked softmax of the scores times V: (B, Q, H, Dh)."""
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    def _project_qkv(self, x: torch.Tensor, w_qkv: torch.Tensor,
                     b_qkv: torch.Tensor | None):
        """(B, W, D) → q, k, v, each (B, W, H, Dh), f32."""
        b, w, d = x.shape
        qkv = torch.matmul(x.float().reshape(b * w, d), w_qkv)
        if b_qkv is not None:
            qkv = qkv + b_qkv
        return split_heads(qkv.reshape(b, w, 3 * d), self.n_heads)

    @staticmethod
    def _out_proj(o: torch.Tensor, w_out: torch.Tensor,
                  b_out: torch.Tensor | None) -> torch.Tensor:
        b, w, h, dh = o.shape
        y = torch.matmul(o.reshape(b * w, h * dh), w_out)
        if b_out is not None:
            y = y + b_out
        return y.reshape(b, w, h * dh)

    def prefill(self, x: torch.Tensor, w_qkv, b_qkv, w_out, b_out):
        """The causal forward over a right-padded prompt that also gives
        each position's K and V: (B, T, D) → ``(y, k, v)``, k and v
        (B, T, H, Dh).  A padded position's K and V are garbage no real
        position sees: the causal mask keeps them out here, and a later
        step overwrites the row before its mask admits it."""
        t = x.shape[1]
        q, k, v = self._project_qkv(x, w_qkv, b_qkv)
        s = self._scores(q, k)
        if self.causal:
            idx = torch.arange(t, device=x.device)
            mask = (idx[:, None] >= idx[None, :])[None, None]
        else:
            mask = torch.ones((1, 1, t, t), dtype=torch.bool,
                              device=x.device)
        o = self._softmax_av(s, mask, v)
        return self._out_proj(o, w_out, b_out), k, v

    def decode_step(self, x: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, pos: torch.Tensor,
                    w_qkv, b_qkv, w_out, b_out):
        """One token a lane over its own cache rows: ``x`` (B, 1, D),
        ``k_cache``/``v_cache`` (B, Tmax, H, Dh), ``pos`` (B,) the
        position of this token in each lane (ragged).  Returns ``(y,
        k_cache, v_cache)``, the rows functionally updated at ``pos``
        (new tensors; the operands are untouched).  Keys past ``pos``
        (a slot's earlier tenant, a prefill's padding) are masked."""
        b, _, d = x.shape
        t_max = k_cache.shape[1]
        q, k, v = self._project_qkv(x, w_qkv, b_qkv)
        rows = torch.arange(b, device=x.device)
        pos = pos.long()
        k_cache = k_cache.index_put((rows, pos), k[:, 0])
        v_cache = v_cache.index_put((rows, pos), v[:, 0])
        s = self._scores(q, k_cache)
        live = torch.arange(t_max, device=x.device)[None, :] <= pos[:, None]
        o = self._softmax_av(s, live[:, None, None, :], v_cache)
        return self._out_proj(o, w_out, b_out), k_cache, v_cache

    @staticmethod
    def _kv_quantize(rows: torch.Tensor):
        """(..., Dh) f32 K or V rows → ``(q int8, scale f32 (...))``:
        symmetric absmax over each head's row, rounded half to even as
        ``jnp.round``."""
        s = torch.clamp_min(rows.abs().amax(dim=-1), 1e-8) / 127.0
        q = torch.clamp(torch.round(rows / s[..., None]), -127, 127)
        return q.to(torch.int8), s

    def _paged_attend(self, q, k_pool, v_pool, tables, q_pos,
                      k_scale=None, v_scale=None) -> torch.Tensor:
        """(B, W, H, Dh) queries at global positions ``q_pos`` (B, W)
        over the pages of ``tables`` (B, nb+1, the last the trash page):
        key position ``p`` is admitted iff ``p <= q_pos``.  int8 pools
        are dequantized with their scale pools on the gather."""
        b = q.shape[0]
        nb = tables.shape[1] - 1
        ptok = k_pool.shape[1]
        dh = q.shape[-1]
        pages = tables[:, :nb].long()
        k_rows = k_pool[pages].reshape(b, nb * ptok, self.n_heads, dh)
        v_rows = v_pool[pages].reshape(b, nb * ptok, self.n_heads, dh)
        if k_scale is not None:
            ks = k_scale[pages].reshape(b, nb * ptok, self.n_heads)
            vs = v_scale[pages].reshape(b, nb * ptok, self.n_heads)
            k_rows = k_rows.float() * ks[..., None]
            v_rows = v_rows.float() * vs[..., None]
        keys = torch.arange(nb * ptok, device=q.device)
        mask = keys[None, None, :] <= q_pos.long()[:, :, None]
        return self._softmax_av(self._scores(q, k_rows), mask[:, None],
                                v_rows)

    @staticmethod
    def _paged_write(pool, rows, tables, positions, live):
        """Write (B, W, ...) rows into ``pool`` in place through the
        block tables at global ``positions`` (B, W); a dead lane or
        position, and a live one past its table, writes into the trash
        page (the table's last entry) at offset 0.  Returns ``pool``."""
        ptok = pool.shape[1]
        nb = tables.shape[1] - 1
        positions = positions.long()
        block = torch.div(positions, ptok, rounding_mode="floor")
        block = torch.where(live & (block < nb), block,
                            torch.full_like(block, nb))
        page = torch.gather(tables.long(), 1, block)
        off = torch.where(live, positions % ptok,
                          torch.zeros_like(positions))
        pool.index_put_((page, off), rows.to(pool.dtype))
        return pool

    def _paged_update(self, k, v, k_pool, v_pool, k_scale, v_scale,
                      tables, positions, live):
        """This window's K and V written through the tables, quantized
        on the write where scale pools ride along (a scale row shares
        its data row's page, offset and trash)."""
        if k_scale is not None:
            k, ks = self._kv_quantize(k)
            v, vs = self._kv_quantize(v)
            k_scale = self._paged_write(k_scale, ks, tables, positions,
                                        live)
            v_scale = self._paged_write(v_scale, vs, tables, positions,
                                        live)
        k_pool = self._paged_write(k_pool, k, tables, positions, live)
        v_pool = self._paged_write(v_pool, v, tables, positions, live)
        return k_pool, v_pool, k_scale, v_scale

    def _paged(self, x, k_pool, v_pool, tables, positions, live, weights,
               k_scale, v_scale):
        w_qkv, b_qkv, w_out, b_out = weights
        q, k, v = self._project_qkv(x, w_qkv, b_qkv)
        k_pool, v_pool, k_scale, v_scale = self._paged_update(
            k, v, k_pool, v_pool, k_scale, v_scale, tables, positions,
            live)
        o = self._paged_attend(q, k_pool, v_pool, tables, positions,
                               k_scale, v_scale)
        y = self._out_proj(o, w_out, b_out)
        if k_scale is not None:
            return y, k_pool, v_pool, k_scale, v_scale
        return y, k_pool, v_pool

    def prefill_paged(self, x, k_pool, v_pool, table, start, length,
                      w_qkv, b_qkv, w_out, b_out, k_scale=None,
                      v_scale=None):
        """A prompt window through the page table: ``x`` (1, W, D) the
        features of positions ``start..start+W-1`` (right-padded past
        ``length`` real tokens; ``start`` and ``length`` 0-dim device
        tensors), ``table`` (nb+1,) the sequence's block row.  Writes
        the window's K and V, attends each position over the cached
        prefix and the window (``<= q_pos``); returns ``(y, k_pool,
        v_pool[, k_scale, v_scale])``, the pools written in place.  At
        ``start > 0`` (the tail after a prefix-cache hit) the shared
        pages below ``start`` are read, never written."""
        idx = torch.arange(x.shape[1], device=x.device)
        positions = (start.long() + idx)[None, :]
        live = (idx < length)[None, :]
        return self._paged(x, k_pool, v_pool, table[None, :], positions,
                           live, (w_qkv, b_qkv, w_out, b_out), k_scale,
                           v_scale)

    def decode_step_paged(self, x, k_pool, v_pool, tables, pos, w_qkv,
                          b_qkv, w_out, b_out, k_scale=None, v_scale=None):
        """One token a lane through the page table: ``x`` (B, 1, D),
        ``tables`` (B, nb+1), ``pos`` (B,) (a padded lane carries the
        trash table and writes there)."""
        positions = pos.long()[:, None]
        live = torch.ones_like(positions, dtype=torch.bool)
        return self._paged(x, k_pool, v_pool, tables, positions, live,
                           (w_qkv, b_qkv, w_out, b_out), k_scale, v_scale)

    def window_paged(self, x, k_pool, v_pool, tables, pos, lengths, w_qkv,
                     b_qkv, w_out, b_out, k_scale=None, v_scale=None):
        """A multi-token window a lane through the page table, in one
        forward: speculative verification (the last accepted token and
        the drafts, ``lengths`` K+1) and the batched tail prefill
        (ragged ``lengths``).  ``x`` (B, W, D) starts at ``pos`` (B,);
        positions past ``lengths`` write into the trash page."""
        idx = torch.arange(x.shape[1], device=x.device)[None, :]
        positions = pos.long()[:, None] + idx
        live = idx < lengths.long()[:, None]
        return self._paged(x, k_pool, v_pool, tables, positions, live,
                           (w_qkv, b_qkv, w_out, b_out), k_scale, v_scale)


class GDMultiHeadAttention(GradientDescentBase):
    """Attention backward: autograd of the output the forward kept,
    then the base update for both parameter pairs."""

    MATCHES = (MultiHeadAttention,)

    def bind_forward(self) -> None:
        super().bind_forward()
        forward_unit = self.forward_unit
        self.alloc_accumulator("accumulated_gradient_weights_out",
                               "weights_out", self.gradient_moment)
        self.alloc_accumulator("accumulated_gradient_bias_out",
                               "bias_out", self.gradient_moment_bias)
        for attr in forward_unit.param_shapes():
            getattr(forward_unit, attr).requires_grad_(True)
        forward_unit.keep_graph = True
        forward_unit.input_grad = self.need_err_input

    def micro_accum_params(self) -> list[tuple[str, str]]:
        # the output projection's pair accumulates too
        return super().micro_accum_params() + [("wo", "weights_out"),
                                               ("bo", "bias_out")]

    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        stash, fwd.stash = fwd.stash, None  # the graph is used once
        if stash is None:
            raise RuntimeError(f"{type(fwd).__name__}: no forward graph "
                               f"kept for this step (run the forward "
                               f"with gradients enabled first)")
        x_leaf, y = stash
        names = list(fwd.param_shapes())
        inputs = [getattr(fwd, n) for n in names]
        if self.need_err_input:
            inputs.append(x_leaf)
        # every gradient is taken before any parameter changes below
        grads = dict(zip(names + ["x"], torch.autograd.grad(
            y, inputs, grad_outputs=err_output.float())))
        ring = fwd.ring
        if ring is not None:
            # each process's gradients cover its block of time
            grads = {k: all_reduce(g, ring.group) for k, g in grads.items()}
        self.apply_weights(grads["weights"])
        self.apply_weights(grads["weights_out"], "weights_out",
                           "accumulated_gradient_weights_out")
        if fwd.include_bias:
            self.apply_bias(grads["bias"])
            self.apply_bias(grads["bias_out"], "bias_out",
                            "accumulated_gradient_bias_out")
        if not self.need_err_input:
            return None
        return grads["x"].to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        """The reference's analytic attention backward."""
        fwd = self.forward_unit
        x = x.astype(np.float32)
        b, t, d = x.shape
        h = fwd.n_heads
        dh = d // h
        _, (qkv, q, k, v, o, p) = fwd.forward_np(x)
        dy = err_output.astype(np.float32).reshape(b * t, d)
        # the output projection
        grad_wo = o.reshape(b * t, d).T @ dy
        grad_bo = dy.sum(axis=0)
        do = (dy @ fwd.np_param("weights_out").T).reshape(b, t, h, dh)
        # the core: dv, the softmax's jacobian, dq and dk
        dv = np.einsum("bhqk,bqhd->bkhd", p, do)
        dp = np.einsum("bqhd,bkhd->bhqk", do, v)
        ds = p * (dp - (dp * p).sum(axis=-1, keepdims=True))
        ds = ds / np.sqrt(dh)
        dq = np.einsum("bhqk,bkhd->bqhd", ds, k)
        dk = np.einsum("bhqk,bqhd->bkhd", ds, q)
        dqkv = np.concatenate(
            [a.reshape(b, t, d) for a in (dq, dk, dv)],
            axis=-1).reshape(b * t, 3 * d)
        # the input projection
        grad_wq = x.reshape(b * t, d).T @ dqkv
        grad_bq = dqkv.sum(axis=0)
        err_input = None
        if self.need_err_input:
            err_input = (dqkv @ fwd.np_param("weights").T).reshape(b, t, d)
        self.numpy_apply_weights(grad_wq)
        if fwd.include_bias:
            self.numpy_apply_bias(grad_bq)
        self.numpy_apply_weights(grad_wo, "weights_out",
                                 "accumulated_gradient_weights_out")
        if fwd.include_bias:
            self.numpy_apply_bias(grad_bo, "bias_out",
                                  "accumulated_gradient_bias_out")
        return err_input
