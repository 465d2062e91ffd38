"""LSTM recurrent layer and its backward (port of ``znicz_tpu/ops/lstm.py``).

One fused (F+H, 4H) f32 weight over the concatenated ``[x_t, h_{t−1}]``
with the gates in the order i|f|g|o, and a (4H,) bias whose forget-gate
quarter starts at +1:

.. code-block:: text

    z = mxu_dot([x_t, h], W) + b
    i, f, o = σ(z_i), σ(z_f), σ(z_o);   g = tanh(z_g)
    c = f·c + i·g;                       h = o·tanh(c)

Each step's product goes through :meth:`mxu_dot`, so in bf16 mode its
operands are rounded to bf16 and it sums in f32, as in the reference;
the carries h and c, the gates and the output stay f32 whatever the
storage dtype (the reference stores an LSTM's output in f32).
``return_sequence`` emits every step's h (B, T, H), else the last
(B, H).

The reference runs the recursion as one ``lax.scan`` of an XLA product
and calls no Pallas kernel; here it is a loop of torch ops over T, which
a CUDA graph captures whole.  ``GDLSTM`` takes ``torch.autograd.grad``
of a recomputed forward, the counterpart of the reference's ``jax.vjp``
of the scan: autograd rounds each step's cotangents of the bf16 casts
where ``jax.vjp`` does.  The error at the output is taken in f32, the
output's dtype (the reference's ``jax.vjp`` refuses the bf16 error a
bf16 chain hands it).

On the numpy oracle the pair is the reference's numpy path: the
forward an explicit loop, the backward explicit backpropagation through
time (the gates' derivatives written out).

The decode entry points (``xla_prefill``, ``xla_decode_step``) belong to
the decode slice.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.ops.nn_units import Forward, GradientDescentBase


class LSTM(Forward):
    """Single-layer LSTM over (batch, time, features) input."""

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None,
                 output_sample_shape=None, units: int | None = None,
                 return_sequence: bool = False, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        units = units if units is not None else output_sample_shape
        if units is None:
            raise ValueError("lstm: units (hidden size) required")
        self.units = int(units)
        self.return_sequence = bool(return_sequence)
        if self.input_shape is not None:
            self.check_input_shape()

    def check_input_shape(self) -> None:
        if len(self.input_shape) != 2:
            raise ValueError(f"lstm expects (time, features) samples, got "
                             f"{self.input_shape}")

    @property
    def output_shape(self) -> tuple:
        if self.return_sequence:
            return (self.input_shape[0], self.units)
        return (self.units,)

    @property
    def output_store_dtype(self) -> torch.dtype:
        return torch.float32

    def param_shapes(self) -> dict[str, tuple]:
        f, h = self.input_shape[1], self.units
        shapes = {"weights": (f + h, 4 * h)}
        if self.include_bias:
            shapes["bias"] = (4 * h,)
        return shapes

    def initial_params(self) -> dict[str, np.ndarray]:
        f, h = self.input_shape[1], self.units
        params = {"weights": self.fill_array(
            (f + h, 4 * h), self.weights_filling, self.weights_stddev,
            fan_in=f + h)}
        if self.include_bias:
            bias = np.zeros(4 * h, dtype=np.float32)
            bias[h:2 * h] = 1.0  # forget gate: remember by default
            params["bias"] = bias
        return params

    def step(self, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
             w: torch.Tensor, b: torch.Tensor | None):
        """One time step: ``(h, c)`` from the input at t and the
        carries."""
        z = self.mxu_dot(torch.cat([x_t, h], dim=1), w)
        if b is not None:
            z = z + b
        i, f, g, o = z.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def scan(self, x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor | None) -> torch.Tensor:
        """The f32 output over the whole sequence, from zero carries."""
        h = torch.zeros((x.shape[0], self.units), dtype=torch.float32,
                        device=x.device)
        c = h
        hs = []
        for t in range(x.shape[1]):
            h, c = self.step(x[:, t], h, c, w, b)
            hs.append(h)
        return torch.stack(hs, dim=1) if self.return_sequence else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scan(x, self.weights,
                         self.bias if self.include_bias else None)

    def step_np(self, x_t, h_prev, c_prev, w, b):
        """One oracle step: ``(h, c, (i, f, g, o))`` (the reference's
        ``_step`` in numpy)."""
        z = np.concatenate([x_t, h_prev], axis=1) @ w
        if b is not None:
            z = z + b
        n = self.units
        i, f, o = (1.0 / (1.0 + np.exp(-z[:, k * n:(k + 1) * n]))
                   for k in (0, 1, 3))
        g = np.tanh(z[:, 2 * n:3 * n])
        c = f * c_prev + i * g
        return o * np.tanh(c), c, (i, f, g, o)

    def numpy_forward(self, x: np.ndarray) -> np.ndarray:
        x = x.astype(np.float32)
        w = self.np_param("weights")
        b = self.np_param("bias") if self.include_bias else None
        batch, steps, _ = x.shape
        h = np.zeros((batch, self.units), np.float32)
        c = np.zeros((batch, self.units), np.float32)
        hs = np.zeros((batch, steps, self.units), np.float32)
        for t in range(steps):
            h, c, _ = self.step_np(x[:, t], h, c, w, b)
            hs[:, t] = h
        return hs if self.return_sequence else h


class GDLSTM(GradientDescentBase):
    """LSTM backward: autograd of a recomputed forward (backpropagation
    through time), then the shared update of the weights and bias."""

    MATCHES = (LSTM,)

    def backprop(self, x: torch.Tensor, err_output: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor | None:
        fwd = self.forward_unit
        with torch.enable_grad():
            x_leaf = x.detach().requires_grad_(self.need_err_input)
            w = fwd.weights.detach().requires_grad_()
            b = fwd.bias.detach().requires_grad_() \
                if fwd.include_bias else None
            out = fwd.scan(x_leaf, w, b)
            inputs = [w] + ([b] if b is not None else []) \
                + ([x_leaf] if self.need_err_input else [])
            # every gradient is taken before any parameter changes below
            grads = list(torch.autograd.grad(out, inputs,
                                             grad_outputs=err_output.float()))
        self.apply_weights(grads.pop(0))
        if b is not None:
            self.apply_bias(grads.pop(0))
        if not self.need_err_input:
            return None
        return grads.pop(0).to(self.act_store_dtype)

    def numpy_backprop(self, x, err_output, y=None):
        """The reference's explicit BPTT, from a forward replay that
        keeps each step's state."""
        fwd = self.forward_unit
        x = x.astype(np.float32)
        w = fwd.np_param("weights")
        b = fwd.np_param("bias") if fwd.include_bias else None
        err = err_output
        batch, steps, features = x.shape
        hsz = fwd.units
        h = np.zeros((batch, hsz), np.float32)
        c = np.zeros((batch, hsz), np.float32)
        cache = []
        for t in range(steps):
            h_prev, c_prev = h, c
            h, c, (i, f, g, o) = fwd.step_np(x[:, t], h_prev, c_prev, w, b)
            cache.append((h_prev, c_prev, c, i, f, g, o))
        grad_w = np.zeros_like(w)
        grad_b = np.zeros(4 * hsz, np.float32)
        grad_x = np.zeros_like(x)
        dh = np.zeros((batch, hsz), np.float32)
        dc = np.zeros((batch, hsz), np.float32)
        for t in reversed(range(steps)):
            h_prev, c_prev, c_t, i, f, g, o = cache[t]
            dh_t = dh + (err[:, t] if fwd.return_sequence
                         else (err if t == steps - 1 else 0.0))
            tc = np.tanh(c_t)
            do = dh_t * tc
            dc_t = dc + dh_t * o * (1.0 - tc * tc)
            di = dc_t * g
            df = dc_t * c_prev
            dg = dc_t * i
            dz = np.concatenate([
                di * i * (1.0 - i), df * f * (1.0 - f),
                dg * (1.0 - g * g), do * o * (1.0 - o)], axis=1)
            xc = np.concatenate([x[:, t], h_prev], axis=1)
            grad_w += xc.T @ dz
            grad_b += dz.sum(axis=0)
            dxc = dz @ w.T
            grad_x[:, t] = dxc[:, :features]
            dh = dxc[:, features:]
            dc = dc_t * f
        self.numpy_apply_weights(grad_w)
        if b is not None:
            self.numpy_apply_bias(grad_b)
        return grad_x if self.need_err_input else None
