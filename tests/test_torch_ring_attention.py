"""Ring attention (sequence parallelism) against the reference
(counterparts of ``tests/test_ring_attention.py`` and
``tests/test_ring_kernel_fold.py``).

In-process, :class:`~znicz_tpu_torch.parallel.ring_attention.LocalRing`
holds every member; its forward and gradients are held to the
reference's kernel fold (its Pallas hops in interpret mode on the
virtual CPU mesh) and to the whole-sequence oracle.  A spawned gloo
world of four ranks runs :class:`ProcessRing` over the ``seq`` axis,
which must give LocalRing's numbers, and trains the attention unit with
``seq_parallel`` against the same unit on one device.  Tolerances: f32
forward 1e-5 and gradients 2e-5 (absolute, on unit-scale inputs; the
fold reorders sums), ProcessRing against LocalRing 1e-6, the unit's
trained parameters 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from znicz_tpu.parallel import ring_attention as ref_ring
from znicz_tpu_torch.ops import flash_attention as fa
from znicz_tpu_torch.parallel import ring_attention as ra


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _ref_fold(n, q, k, v, causal, ct):
    """The reference's kernel fold: ``(out, (dq, dk, dv))``."""
    mesh = ref_ring.make_seq_mesh(n)
    fn = lambda *a: ref_ring.sequence_sharded_attention(  # noqa: E731
        mesh, *a, causal=causal, pallas_fold=True, pallas_interpret=True)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp(jnp.asarray(ct))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _local_ring(n, q, k, v, causal, ct):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    out = ra.sequence_sharded_attention(ra.LocalRing(n), *ts, causal=causal)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [pytest.param(2, marks=pytest.mark.slow), 4])
def test_local_ring_equals_the_reference_kernel_fold(causal, n):
    """Four members in tier 1; two in the slow tier, as the reference
    marks its kernel-fold tests (each call runs its Pallas hops in
    interpret mode, ~20 s on the CPU)."""
    shape = (2, 16 * n, 2, 8)
    q, k, v, ct = (_rand(shape, s) for s in (1, 2, 3, 9))
    out, grads = _local_ring(n, q, k, v, causal, ct)
    ref_out, ref_grads = _ref_fold(n, q, k, v, causal, ct)
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    for name, g, r in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_local_ring_equals_one_flash_call(causal):
    """The fold of 4 hops against one whole-sequence flash call (the
    kernels' plain versions here; the card holds the kernels), forward
    and every gradient."""
    shape = (2, 64, 2, 16)
    q, k, v, ct = (_rand(shape, s) for s in (4, 5, 6, 7))
    out, grads = _local_ring(4, q, k, v, causal, ct)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    whole = fa.flash_attention(*ts, causal=causal)
    want = torch.autograd.grad(whole, ts, torch.from_numpy(ct))
    np.testing.assert_allclose(out, whole.detach().numpy(), atol=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g, w.numpy(), atol=2e-5)


def test_ring_lse_cotangent_enters_delta():
    """Differentiating through the ring's lse (as a caller composing
    rings would) matches autograd of the plain whole-sequence lse."""
    shape = (1, 32, 2, 8)
    q, k, v = (torch.from_numpy(_rand(shape, s)).requires_grad_(True)
               for s in (11, 12, 13))
    ring = ra.LocalRing(4)
    outs = ra.RingFold.apply(ring, "plain", True, *q.chunk(4, 1),
                             *k.chunk(4, 1), *v.chunk(4, 1))
    lse = torch.cat(outs[4:], dim=-1)
    (gq,) = torch.autograd.grad(lse.sum(), (q,))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    mask = torch.tril(torch.ones(32, 32, dtype=torch.bool))
    ref = torch.logsumexp(s.masked_fill(~mask, -1e30), dim=-1)
    (rq,) = torch.autograd.grad(ref.sum(), (q,))
    np.testing.assert_allclose(gq.numpy(), rq.numpy(), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_k", [8, 16, 32])
def test_blocked_equals_the_reference(causal, block_k):
    shape = (2, 32, 2, 8)
    q, k, v = (_rand(shape, s) for s in (1, 2, 3))
    got = ra.local_attention_blocked(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        block_k=block_k)
    with jax.default_matmul_precision("highest"):
        want = ref_ring.local_attention_blocked(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
            block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        ra.local_attention_blocked(*(torch.from_numpy(a) for a in (q, k, v)),
                                   block_k=12)


def test_fold_choice_follows_the_kernels_rule():
    """dh 4 takes the plain fold (the reference's scan fold); the plain
    fold is the same ring on the kernels' plain versions."""
    assert ra.ring_fold_choice((2, 32, 2, 8), 2) == "kernel"
    assert ra.ring_fold_choice((2, 32, 2, 4), 2) == "plain"
    mesh = ref_ring.make_seq_mesh(2)
    assert ref_ring.ring_fold_choice(mesh, (2, 32, 2, 4),
                                     pallas_fold=True)[0] == "scan"
    with pytest.raises(ValueError, match="split"):
        ra.ring_fold_choice((2, 30, 2, 8), 4)
    q = torch.from_numpy(_rand((2, 32, 2, 4), 1))
    got = ra.sequence_sharded_attention(ra.LocalRing(2), q, q, q, causal=True)
    want = fa.local_attention(q, q, q, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ----------------------------------------------------------------------
# ProcessRing in a spawned world of four ranks
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    return worker.spawn_world("ring", 4, tmp_path_factory.mktemp("ring"))


@pytest.mark.parametrize("causal", [False, True])
def test_process_ring_equals_local_ring(ring_world, causal):
    q, k, v, ct = worker.ring_inputs()
    out, grads = _local_ring(4, q, k, v, causal, ct)
    got = [np.concatenate([rank[causal][i] for rank in ring_world], axis=1)
           for i in range(4)]
    assert [rank["rank_in_ring"] for rank in ring_world] == [0, 1, 2, 3]
    np.testing.assert_allclose(got[0], out, atol=1e-6)
    for g, w in zip(got[1:], grads):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_seq_parallel_unit_trains_as_on_one_device(ring_world):
    """The attention unit with ``seq_parallel`` over the four-rank ring
    (its blocks projected, the ring, the output gathered along time; the
    gradients summed over the ring) trains the classifier to the
    parameters of the same run on one device."""
    want = worker.ring_unit_step(None)
    for rank in ring_world:
        for a, b in zip(want, rank["unit"]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
