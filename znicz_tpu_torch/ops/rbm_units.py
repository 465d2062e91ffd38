"""Restricted Boltzmann machine units (port of
``znicz_tpu/ops/rbm_units.py``): the ``mnist_rbm`` sample's training
stack, ``Binarization``, ``BatchWeights``, ``GradientRBM`` and
``EvaluatorRBM``.

Training is CD-k (contrastive divergence):

.. code-block:: text

    h0 = σ(v0·W + hb)            (All2AllSigmoid, the encoder)
    s0 = bernoulli(h0)           (Binarization)
    v1 = σ(s0·Wᵀ + vb)           (reconstruction; probabilities)
    h1 = σ(v1·W + hb)
    ΔW = (v0ᵀh0 − v1ᵀh1)/n;  Δhb = mean(h0−h1);  Δvb = mean(v0−v1)

On a device the chain is a few products and elementwise passes in f32,
run in the region's step with autograd off (an RBM has no backward
chain).  A Bernoulli draw compares the probability with a uniform in
[0, 1) made of the top 24 of the 32 random bits of element *i* under a
seed, the bits of the dropout kernel's plain version
(:func:`~znicz_tpu_torch.ops.fused_kernels.dropout_bits`), as stochastic
pooling draws them.  The seed comes from the unit's
:class:`~znicz_tpu_torch.utils.prng.SeedChain`, which the step advances
on the device, so a replayed CUDA graph draws anew on every step with
no host work, and the eager and graphed runs of one workflow draw the
same samples.  Each extra Gibbs step of CD-k (k > 1) takes the next
seed of ``GradientRBM``'s own chain.

``GradientRBM`` updates the encoder's ``weights`` and ``bias`` (its
``hbias``), which it shares, and its own ``vbias`` in place: a captured
graph reads and writes the addresses it captured.

On the numpy oracle each unit runs the reference's numpy path, drawing
its uniforms from the default generator's host stream in the
reference's order, so the oracle's run equals the reference's oracle
bit for bit.  Device streams differ from the reference's by design.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.ops.evaluator import EvaluatorMSE
from znicz_tpu_torch.ops.fused_kernels import dropout_bits
from znicz_tpu_torch.ops.nn_units import (Forward, ModuleUnit, Stochastic,
                                          as_numpy, stored_f32)
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.prng import SeedChain


def _sigmoid(xp, x):
    return 1.0 / (1.0 + xp.exp(-x))


def bernoulli(p: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """``1[u < p]`` in f32, ``u`` the 24-bit uniform of each element
    under ``seed`` (a 0-d int64 device tensor)."""
    bits = dropout_bits(p.numel(), seed, p.device)
    u = ((bits >> 8).float() * 2.0 ** -24).view(p.shape)
    return (u < p.float()).float()


class Binarization(Stochastic, Forward):
    """Bernoulli-sample a probability tensor: ``out = 1[u < p]`` (the
    reference's ``Binarization``, which feeds the sampled hidden states
    into the CD chain).  It samples on every step, train or not, as the
    reference's does: ``forward_mode`` stays "train" (it is not linked
    to the loader)."""

    EXPORT_PARAMS = ()

    def __init__(self, input_shape=None,
                 compute_dtype: torch.dtype | None = None, **kwargs) -> None:
        super().__init__(input_shape, compute_dtype, **kwargs)
        self.init_stochastic()

    def param_shapes(self) -> dict[str, tuple]:
        return {}

    def initial_params(self) -> dict:
        return {}

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        seed = self.next_seed(p.device)
        return bernoulli(p, seed).to(self.output_store_dtype)

    def numpy_forward(self, p: np.ndarray) -> np.ndarray:
        u = prng.get().numpy.uniform(size=p.shape)
        return (u < p).astype(np.float32)


class BatchWeights(AcceleratedUnit):
    """Batch outer product ``vᵀh / n`` plus column means: the sufficient
    statistics of one CD phase (the reference's ``BatchWeights``;
    ``GradientRBM`` computes two of these)."""

    DATA_PARALLEL = False
    DATA_PARALLEL_NOTE = "a statistic over the whole minibatch"

    WRITES = ("weights_batch", "v_mean", "h_mean")

    def __init__(self, workflow=None, name: str | None = None,
                 **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.weights_batch = None       # (nv, nh)
        self.v_mean = None              # (nv,)
        self.h_mean = None              # (nh,)

    @staticmethod
    def stats(xp, v, h):
        n = v.shape[0]
        return v.T @ h / n, v.mean(axis=0), h.mean(axis=0)

    @torch.no_grad()
    def device_run(self) -> None:
        self.weights_batch, self.v_mean, self.h_mean = self.stats(
            torch, self.v.float(), self.h.float())

    def numpy_run(self) -> None:
        self.weights_batch, self.v_mean, self.h_mean = (
            stored_f32(a) for a in self.stats(
                np, as_numpy(self.v), as_numpy(self.h)))


class GradientRBM(ModuleUnit):
    """CD-k weight update and reconstruction (the reference's
    ``GradientRBM``).

    Links: ``input`` = v0 (the data), ``hidden`` = the h0
    probabilities, ``hidden_sample`` = the binarized h0, and the
    encoder's ``weights`` (nv, nh) and ``bias`` (as ``hbias``), which it
    updates in place; it owns ``vbias`` (zero unless set before
    ``initialize``) and, with a ``gradient_moment``, the momentum
    ``_acc_w``, ``_acc_vb`` and ``_acc_hb``.  ``forward_mode`` (linked
    from the loader) gates the update, and is part of the region's key:
    an eval minibatch only computes the reconstruction.
    """

    DATA_PARALLEL = False
    DATA_PARALLEL_NOTE = "its update is not folded over the data axis"

    WRITES = ("reconstruction",)

    def __init__(self, workflow=None, name: str | None = None,
                 learning_rate: float = 0.1, gradient_moment: float = 0.0,
                 cd_k: int = 1, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.learning_rate = learning_rate
        self.gradient_moment = gradient_moment
        self.cd_k = int(cd_k)
        self.forward_mode = "train"     # usually linked from the loader
        self.reconstruction = None
        self.register_buffer("vbias", None)
        for name_ in ("_acc_w", "_acc_vb", "_acc_hb"):
            self.register_buffer(name_, None)
        self.__dict__["seed_chain"] = SeedChain()

    def region_key(self) -> tuple:
        return (self.forward_mode,)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device=device, **kwargs)
        w, hb = self.weights, self.hbias   # AttributeError: defer
        dev = w.device
        nv = w.shape[0]
        self.vbias = (torch.zeros(nv, dtype=torch.float32, device=dev)
                      if self.vbias is None
                      else self.vbias.to(dev, torch.float32))
        if self.gradient_moment:
            self._acc_w = torch.zeros_like(w, dtype=torch.float32)
            self._acc_vb = torch.zeros(nv, dtype=torch.float32, device=dev)
            self._acc_hb = torch.zeros_like(hb, dtype=torch.float32)

    def sync_host_state(self) -> None:
        if self.cd_k > 1:
            self.seed_chain.sync(self.torch_device)

    def written_values(self) -> list[tuple[str, object]]:
        out = super().written_values()
        enc = self._linked_attrs["weights"].source \
            if "weights" in self._linked_attrs else self
        out += [(f"{enc.name}.weights", self.weights),
                (f"{enc.name}.bias", self.hbias)]
        out += list(self.named_buffers(recurse=False))
        return out

    # -- the CD chain (xp-generic but for the sampling) --------------------
    def _gibbs(self, xp, v0, h0, s0, w, hb, vb, sample):
        """One CD-k chain from the sampled h; returns (v1, h1)."""
        s = s0
        for _ in range(self.cd_k):
            v1 = _sigmoid(xp, s @ w.T + vb)
            h1 = _sigmoid(xp, v1 @ w + hb)
            if self.cd_k > 1:
                s = sample(h1)
        return v1, h1

    def device_run(self) -> None:
        self.reconstruction = self.cd(self.input, self.hidden,
                                      self.hidden_sample)

    @torch.no_grad()
    def cd(self, v0: torch.Tensor, h0: torch.Tensor,
           s0: torch.Tensor) -> torch.Tensor:
        """One CD-k step from the data ``v0``, the hidden probabilities
        ``h0`` and their sample ``s0``: returns the reconstruction and,
        in train mode, updates the parameters in place."""
        n = v0.shape[0]
        v0 = v0.reshape(n, -1).float()
        h0, s0 = h0.float(), s0.float()
        w, hb, vb = self.weights, self.hbias, self.vbias

        def sample(p):
            return bernoulli(p, self.seed_chain.next(p.device))

        v1, h1 = self._gibbs(torch, v0, h0, s0, w, hb, vb, sample)
        if self.forward_mode != "train":
            return v1
        pos_w, pos_v, pos_h = BatchWeights.stats(torch, v0, h0)
        neg_w, neg_v, neg_h = BatchWeights.stats(torch, v1, h1)
        lr, m = self.learning_rate, self.gradient_moment
        for param, grad, acc in ((w, pos_w - neg_w, self._acc_w),
                                 (vb, pos_v - neg_v, self._acc_vb),
                                 (hb, pos_h - neg_h, self._acc_hb)):
            if m:
                acc.copy_(m * acc + lr * grad)
                param.add_(acc)
            else:
                param.add_(lr * grad)
        return v1

    def numpy_run(self) -> None:
        n = self.input.shape[0]
        v0 = as_numpy(self.input).reshape(n, -1).astype(np.float32)
        h0 = as_numpy(self.hidden)
        s0 = as_numpy(self.hidden_sample)
        w = as_numpy(self.weights)
        hb, vb = as_numpy(self.hbias), as_numpy(self.vbias)
        rnd = prng.get().numpy

        def sample(p):
            return (rnd.uniform(size=p.shape) < p).astype(np.float32)

        v1, h1 = self._gibbs(np, v0, h0, s0, w, hb, vb, sample)
        self.reconstruction = stored_f32(v1)
        if self.forward_mode != "train":
            return
        pos_w, pos_v, pos_h = BatchWeights.stats(np, v0, h0)
        neg_w, neg_v, neg_h = BatchWeights.stats(np, v1, h1)
        self._apply_np(w, pos_w - neg_w, self._acc_w)
        self._apply_np(vb, pos_v - neg_v, self._acc_vb)
        self._apply_np(hb, pos_h - neg_h, self._acc_hb)

    def _apply_np(self, param, grad, acc) -> None:
        if self.gradient_moment:
            acc = as_numpy(acc)
            acc *= self.gradient_moment
            acc += self.learning_rate * grad
            param += acc
        else:
            param += self.learning_rate * grad


class EvaluatorRBM(EvaluatorMSE):
    """Reconstruction-error evaluator (the reference's ``EvaluatorRBM``):
    the MSE between ``GradientRBM.reconstruction`` and the input data.
    The ``err_output`` it gives is unused (an RBM has no backward
    chain), but the epoch sums drive ``DecisionMSE`` unchanged."""
