"""The port's embedding pair against the reference, on the CPU.

The forward is a gather of the same f32 table (the initial fill drawn
from the same seed), so it must be exact, and so must the out-of-
vocabulary clamp.  The backward's table gradient is the error rows
added at their tokens; the port adds them in a deterministic order
(``index_put_`` with ``accumulate=True``), which on the CPU is the
order ``np.add.at`` takes, so the gradient must equal ``np.add.at``'s
bit for bit.  The update after it (momentum SGD) is held to the
reference's within 1e-6 of the largest |value|: the same f32 formula,
written in two libraries.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.ops import embedding as ref_emb
from znicz_tpu.utils import prng as ref_prng
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.ops import embedding
from znicz_tpu_torch.ops.nn_units import gd_for
from znicz_tpu_torch.utils import prng
from znicz_tpu_torch.utils.config import reset_root

B, T, V, D = 3, 6, 11, 8
GD = {"learning_rate": 0.1, "gradient_moment": 0.9}


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, size=(B, T)).astype(np.float32)


def _reference(device, tokens, err):
    """The reference's pair: (initial table, output, updated table)."""
    ref_prng.seed_all(8)
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(tokens.copy(), name="tok"))
    fwd = ref_emb.Embedding(wf, vocab_size=V, dim=D)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=device)
    bwd = ref_emb.GDEmbedding(wf, **GD)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output", "weights", "bias")
    bwd.err_output = Vector(err.copy(), name="err", batch_major=True)
    bwd.initialize(device=device)
    fwd.weights.map_read()
    w0 = np.array(fwd.weights.mem, copy=True)
    fwd.run()
    fwd.output.map_read()
    y = np.array(fwd.output.mem, np.float32, copy=True)
    bwd.run()
    fwd.weights.map_read()
    return w0, y, np.array(fwd.weights.mem, copy=True)


def _port(tokens, err):
    prng.seed_all(8)
    fwd = embedding.Embedding((T,), torch.float32, vocab_size=V, dim=D)
    fwd.init_params("cpu")
    bwd = gd_for(type(fwd))(fwd, **GD)
    w0 = fwd.weights.detach().numpy().copy()
    x = torch.from_numpy(tokens)
    y = fwd(x)
    assert bwd.run(x, torch.from_numpy(err), y) is None
    return w0, y.numpy(), fwd.weights.detach().numpy().copy()


@pytest.mark.parametrize("backend", ["numpy_run", "xla_run"])
def test_forward_and_update_match_the_reference(backend):
    tokens = _tokens()
    tokens[0, :3] = 4.0  # repeats must add up, not overwrite
    err = np.random.default_rng(2).normal(size=(B, T, D)).astype(np.float32)
    device = NumpyDevice() if backend == "numpy_run" else XLADevice()
    want = _reference(device, tokens, err)
    got = _port(tokens, err)
    np.testing.assert_array_equal(got[0], want[0])  # the seeded fill
    np.testing.assert_array_equal(got[1], want[1])  # the gather
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=1e-6 * np.abs(want[2]).max())
    assert not np.array_equal(got[2], got[0])


def test_gradient_is_np_add_at_bit_for_bit():
    """The deterministic scatter-add against ``np.add.at`` on many
    repeats of few tokens (4096 rows onto 16), the LM's pattern."""
    rng = np.random.default_rng(5)
    n, v, d = 4096, 16, 24
    tokens = rng.integers(0, v, size=(8, n // 8)).astype(np.float32)
    err = rng.normal(size=(8, n // 8, d)).astype(np.float32)
    fwd = embedding.Embedding((n // 8,), torch.float32, vocab_size=v, dim=d)
    fwd.init_params("cpu")
    w0 = fwd.weights.detach().clone()
    # learning rate 1, no momentum: the update is w0 − grad, and the
    # gradient itself is read before it
    captured = []
    bwd = gd_for(type(fwd))(fwd, learning_rate=1.0)
    bwd.apply_weights = captured.append
    bwd.run(torch.from_numpy(tokens), torch.from_numpy(err), None)
    want = np.zeros((v, d), np.float32)
    np.add.at(want, tokens.astype(np.int64).reshape(-1), err.reshape(-1, d))
    (grad,) = captured
    assert grad.dtype == torch.float32
    np.testing.assert_array_equal(grad.numpy(), want)
    # and the same bits on a rerun
    bwd.run(torch.from_numpy(tokens), torch.from_numpy(err), None)
    np.testing.assert_array_equal(captured[1].numpy(), grad.numpy())
    assert torch.equal(fwd.weights, w0)  # apply_weights was replaced


def test_tokens_round_and_clamp():
    fwd = embedding.Embedding((5,), torch.float32, vocab_size=V, dim=D)
    fwd.init_params("cpu")
    x = torch.tensor([[-3.0, 2.4999, 2.5, 3.5, V + 3.0]])
    np.testing.assert_array_equal(fwd.tokens(x).numpy(),
                                  [[0, 2, 2, 4, V - 1]])
    ref_prng.seed_all(8)
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.numpy().copy(), name="tok"))
    ref = ref_emb.Embedding(wf, vocab_size=V, dim=D)
    ref.link_attrs(src, ("input", "output"))
    ref.initialize(device=NumpyDevice())
    np.testing.assert_array_equal(fwd.tokens(x).numpy(),
                                  ref._tokens(np, x.numpy()))
    y = fwd(x)
    np.testing.assert_array_equal(y[0, -1].detach().numpy(),
                                  fwd.weights[V - 1].detach().numpy())


def test_bf16_storage_vocabulary_guard():
    """bf16 storage holds the integers up to 256 exactly: a vocabulary
    of 257 fits, 258 does not (as the reference's guard)."""
    embedding.Embedding((4,), torch.bfloat16, vocab_size=257, dim=D)
    with pytest.raises(ValueError, match="exactly"):
        embedding.Embedding((4,), torch.bfloat16, vocab_size=258, dim=D)
    embedding.Embedding((4,), torch.float32, vocab_size=50_000, dim=D)
    # ids up to 256 survive the bf16 round trip the loader makes
    ids = torch.arange(257, dtype=torch.float32)
    assert torch.equal(ids.bfloat16().float(), ids)


def test_no_err_input_and_no_bias():
    fwd = embedding.Embedding((T,), torch.float32, vocab_size=V, dim=D)
    with pytest.raises(ValueError, match="first trainable layer"):
        gd_for(type(fwd))(fwd, need_err_input=True)
    with pytest.raises(ValueError, match="no bias"):
        embedding.Embedding((T,), torch.float32, vocab_size=V, dim=D,
                            include_bias=True)
    assert layer_type("embedding") is embedding.Embedding
    assert fwd.EXPORT_PARAMS == ("weights",)
    assert fwd.output_shape == (T, D)
    fwd.init_params("cpu")
    assert float(fwd.weights.std()) == pytest.approx(0.02, rel=0.3)
