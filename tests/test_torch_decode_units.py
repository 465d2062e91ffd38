"""The decode entry points of the port's units against the reference's
``xla_*`` twins, on the CPU.

The same seeded inputs go through the reference's pure decode functions
(``xla_embed``, the encoding's ``xla_decode_step``, the LSTM's
``xla_prefill``/``xla_decode_step``, attention's flat, paged and window
forms) and through the port's (``embed``, ``decode_step``, ``prefill``,
``prefill_paged``, ``decode_step_paged``, ``window_paged``).  Both compute
in f32 with the same rounding points; the products and softmax sums add
in other orders, so outputs and K/V are held within ``TOL`` of the
largest |reference| value (the f32 bound of
``tests/test_torch_lm.py``).  Gathers, the encoding's add and the int8
quantizer have no order to differ in: they must be bit-equal.  With int8
pages, a K or V entry within an f32 ulp of a rounding boundary may land
one int8 step apart; such a step moves a dequantized entry by its row's
scale (1/127 of the row's largest |value|), so those outputs are held
within ``INT8_TOL``.

The port's paged forms write their pools in place; the pools are checked
after the writes: every page but the trash page equals the reference's
returned pool, the padded lanes' and positions' writes all land in the
trash page, and no page the writes do not address changes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.dummy import DummyWorkflow
from znicz_tpu.ops import attention as ref_attention
from znicz_tpu.ops import embedding as ref_embedding
from znicz_tpu.ops import lstm as ref_lstm
from znicz_tpu.ops import pos_encoding as ref_pe
from znicz_tpu_torch.ops.all2all import All2AllSoftmax, All2AllTanh
from znicz_tpu_torch.ops.attention import MultiHeadAttention
from znicz_tpu_torch.ops.embedding import Embedding
from znicz_tpu_torch.ops.lstm import LSTM
from znicz_tpu_torch.ops.pos_encoding import PositionalEncoding
from znicz_tpu_torch.utils.config import reset_root

TOL = 1e-5
INT8_TOL = 2.0 / 127
D, H, PTOK, POOL = 8, 2, 4, 6
TRASH = POOL


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _weights(rng, d=D):
    return (rng.normal(0, 0.4, (d, 3 * d)).astype(np.float32),
            rng.normal(0, 0.1, 3 * d).astype(np.float32),
            rng.normal(0, 0.4, (d, d)).astype(np.float32),
            rng.normal(0, 0.1, d).astype(np.float32))


def _ref(fn, *args, **kwargs):
    """A reference decode function on jax arrays (its scatters need
    them)."""
    def j(a):
        return jnp.asarray(a) if isinstance(a, np.ndarray) else a
    return fn(*map(j, args), **{k: j(v) for k, v in kwargs.items()})


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _attention():
    ref = ref_attention.MultiHeadAttention(DummyWorkflow(), n_heads=H,
                                           causal=True)
    port = MultiHeadAttention((4, D), torch.float32, n_heads=H, causal=True)
    return ref, port


def _pools(rng, dtype=np.float32):
    k = rng.normal(0, 1, (POOL + 1, PTOK, H, D // H)).astype(np.float32)
    v = rng.normal(0, 1, (POOL + 1, PTOK, H, D // H)).astype(np.float32)
    return k.astype(dtype), v.astype(dtype)


def _check_pools(port_pools, ref_pools, before, written, tol=TOL):
    """Every page but the trash page equals the reference's pool; a row
    the writes do not address keeps its value before them."""
    for got, want, old in zip(port_pools, ref_pools, before):
        got, want = got.numpy(), np.asarray(want)
        _close(got[:TRASH], want[:TRASH], tol)
        keep = np.ones(got.shape[:2], bool)
        for page, off in written:
            keep[page, off] = False
        keep[TRASH] = False
        np.testing.assert_array_equal(got[keep], old[keep])


# ----------------------------------------------------------------------
# the gathers and the encoding step: bit-equal
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5,), (3, 4)])
def test_embed_is_xla_embed_bit_for_bit(shape):
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (12, D)).astype(np.float32)
    ids = rng.uniform(-3, 15, shape).astype(np.float32)  # clipped ends
    ids.flat[0] = 2.5  # rounds half to even
    ref = ref_embedding.Embedding(DummyWorkflow(), vocab_size=12, dim=D)
    port = Embedding((4,), torch.float32, vocab_size=12, dim=D)
    want = np.asarray(ref.xla_embed(w, ids))
    got = port.embed(torch.from_numpy(w), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    ints = torch.from_numpy(np.round(ids).astype(np.int32).clip(0, 11))
    np.testing.assert_array_equal(
        port.embed(torch.from_numpy(w), ints).numpy(), want)


def test_pos_encoding_step_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(2)
    unit = PositionalEncoding((4, D), scale=0.5)
    table = unit.table_to(32, D)
    ref = ref_pe.PositionalEncoding(DummyWorkflow(), scale=0.5)
    ref.scale = 0.5
    np.testing.assert_array_equal(table, ref.table_to(32, D))
    x = rng.normal(0, 1, (5, 1, D)).astype(np.float32)
    pos = np.asarray([0, 7, 31, 3, 3], np.int32)
    want = np.asarray(ref.xla_decode_step(x, pos, table))
    got = unit.decode_step(*_t(x, pos, table)).numpy()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# the LSTM's carries
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_length", [False, True])
def test_lstm_prefill_with_lengths(with_length):
    rng = np.random.default_rng(3)
    f, hsz, t = 6, 5, 7
    x = rng.normal(0, 1, (3, t, f)).astype(np.float32)
    w = rng.normal(0, 0.4, (f + hsz, 4 * hsz)).astype(np.float32)
    b = rng.normal(0, 0.1, 4 * hsz).astype(np.float32)
    length = np.asarray([7, 1, 4], np.int32) if with_length else None
    ref = ref_lstm.LSTM(DummyWorkflow(), units=hsz, return_sequence=True)
    port = LSTM((t, f), torch.float32, units=hsz, return_sequence=True)
    want = ref.xla_prefill(x, w, b, length=length)
    got = port.prefill(*_t(x, w, b), length=None if length is None
                       else torch.from_numpy(length))
    for g, r in zip(got, want):
        _close(g.numpy(), r)
    if with_length:
        # a row's carries are those at its own last real step
        short = port.prefill(*_t(x[1:2, :1], w, b))
        _close(got[1][1:2].numpy(), short[1].numpy())


def test_lstm_decode_step():
    rng = np.random.default_rng(4)
    f, hsz = 6, 5
    x = rng.normal(0, 1, (4, 1, f)).astype(np.float32)
    h = rng.normal(0, 0.5, (4, hsz)).astype(np.float32)
    c = rng.normal(0, 0.5, (4, hsz)).astype(np.float32)
    w = rng.normal(0, 0.4, (f + hsz, 4 * hsz)).astype(np.float32)
    b = rng.normal(0, 0.1, 4 * hsz).astype(np.float32)
    ref = ref_lstm.LSTM(DummyWorkflow(), units=hsz)
    port = LSTM((3, f), torch.float32, units=hsz)
    want = ref.xla_decode_step(x, h, c, w, b)
    got = port.decode_step(*_t(x, h, c, w, b))
    for g, r in zip(got, want):
        _close(g.numpy(), r)


# ----------------------------------------------------------------------
# attention: the flat forms
# ----------------------------------------------------------------------
def test_flat_prefill_gives_each_positions_k_and_v():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 6, D)).astype(np.float32)
    ws = _weights(rng)
    ref, port = _attention()
    want = ref.xla_prefill(x, *ws)
    got = port.prefill(*_t(x, *ws))
    for g, r in zip(got, want):
        _close(g.numpy(), r)
    # the full causal forward's output, through the oracle's path
    port.load_params(dict(zip(("weights", "bias", "weights_out",
                               "bias_out"), _t(*ws))))
    _close(got[0].numpy(), port.forward_np(x)[0])


def test_flat_decode_step_writes_pos_and_masks_past_it():
    rng = np.random.default_rng(6)
    t_max = 8
    x = rng.normal(0, 1, (3, 1, D)).astype(np.float32)
    kc = rng.normal(0, 1, (3, t_max, H, D // H)).astype(np.float32)
    vc = rng.normal(0, 1, (3, t_max, H, D // H)).astype(np.float32)
    pos = np.asarray([0, 5, 7], np.int32)
    ws = _weights(rng)
    ref, port = _attention()
    want = _ref(ref.xla_decode_step, x, kc, vc, pos, *ws)
    kt, vt = _t(kc, vc)
    got = port.decode_step(_t(x)[0], kt, vt, torch.from_numpy(pos),
                           *_t(*ws))
    for g, r in zip(got, want):
        _close(g.numpy(), r)
    # functional: the operands are untouched
    np.testing.assert_array_equal(kt.numpy(), kc)
    np.testing.assert_array_equal(vt.numpy(), vc)
    # rows past pos do not reach the output: garbage there changes nothing
    kg, vg = kc.copy(), vc.copy()
    kg[0, 1:], vg[0, 1:] = 1e3, -1e3
    again = port.decode_step(_t(x)[0], *_t(kg, vg), torch.from_numpy(pos),
                             *_t(*ws))
    np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())


# ----------------------------------------------------------------------
# attention: the paged forms, written in place
# ----------------------------------------------------------------------
@pytest.mark.parametrize("start,length,width", [(0, 5, 8), (6, 3, 4),
                                                (4, 4, 4)])
def test_paged_prefill(start, length, width):
    """A fresh window (start 0) and the tail after a prefix hit (start >
    0, the shared rows below start read and not written)."""
    rng = np.random.default_rng(7 + start)
    nb = 4
    table = np.asarray([2, 0, 5, 3, TRASH], np.int32)
    x = rng.normal(0, 1, (1, width, D)).astype(np.float32)
    kp, vp = _pools(rng)
    ws = _weights(rng)
    ref, port = _attention()
    y_ref, k_ref, v_ref = _ref(ref.xla_prefill_paged, x, kp, vp, table,
                               np.int32(start), np.int32(length), *ws)
    kt, vt = _t(kp, vp)
    y, k_out, v_out = port.prefill_paged(
        _t(x)[0], kt, vt, torch.from_numpy(table), torch.tensor(start),
        torch.tensor(length), *_t(*ws))
    assert k_out is kt and v_out is vt  # in place
    _close(y[:, :length].numpy(), np.asarray(y_ref)[:, :length])
    written = [(table[p // PTOK], p % PTOK)
               for p in range(start, start + length) if p // PTOK < nb]
    _check_pools((kt, vt), (k_ref, v_ref), (kp, vp), written)


def test_paged_decode_step_padded_lanes_write_the_trash_page():
    rng = np.random.default_rng(8)
    nb = 2
    tables = np.asarray([[1, 4, TRASH], [3, 0, TRASH],
                         [TRASH] * 3, [TRASH] * 3], np.int32)
    pos = np.asarray([6, 2, 0, 0], np.int32)  # two padded lanes
    x = rng.normal(0, 1, (4, 1, D)).astype(np.float32)
    kp, vp = _pools(rng)
    ws = _weights(rng)
    ref, port = _attention()
    y_ref, k_ref, v_ref = _ref(ref.xla_decode_step_paged, x, kp, vp,
                               tables, pos, *ws)
    kt, vt = _t(kp, vp)
    y, _, _ = port.decode_step_paged(_t(x)[0], kt, vt,
                                     torch.from_numpy(tables),
                                     torch.from_numpy(pos), *_t(*ws))
    _close(y[:2].numpy(), np.asarray(y_ref)[:2])
    written = [(tables[0, 6 // PTOK], 6 % PTOK), (tables[1, 0], 2)]
    _check_pools((kt, vt), (k_ref, v_ref), (kp, vp), written)
    assert nb == tables.shape[1] - 1
    # the padded lanes' rows are in the trash page (offset 0)
    assert not np.array_equal(kt.numpy()[TRASH, 0], kp[TRASH, 0])


@pytest.mark.parametrize("quant", [False, True])
def test_window_ragged_lengths(quant):
    """Verification and admission windows: ragged lengths, positions
    past a lane's length and past its table sent to the trash page."""
    rng = np.random.default_rng(9)
    w_len = 4
    tables = np.asarray([[1, 4, TRASH], [3, 0, TRASH],
                         [2, TRASH, TRASH]], np.int32)
    pos = np.asarray([5, 1, 2], np.int32)
    lengths = np.asarray([3, 4, 2], np.int32)
    x = rng.normal(0, 1, (3, w_len, D)).astype(np.float32)
    ws = _weights(rng)
    ref, port = _attention()
    if quant:
        kf, vf = _pools(rng)
        kq, ks = (np.asarray(a) for a in ref._kv_quantize(kf))
        vq, vs = (np.asarray(a) for a in ref._kv_quantize(vf))
        pools = (kq, vq, ks, vs)
        want = _ref(ref.xla_window_paged, x, kq, vq, tables, pos, lengths,
                    *ws, k_scale=ks, v_scale=vs)
        tensors = _t(*pools)
        got = port.window_paged(_t(x)[0], tensors[0], tensors[1],
                                *_t(tables, pos, lengths), *_t(*ws),
                                k_scale=tensors[2], v_scale=tensors[3])
        tol = INT8_TOL
    else:
        pools = _pools(rng)
        want = _ref(ref.xla_window_paged, x, *pools, tables, pos, lengths,
                    *ws)
        tensors = _t(*pools)
        got = port.window_paged(_t(x)[0], *tensors,
                                *_t(tables, pos, lengths), *_t(*ws))
        tol = TOL
    for i, n in enumerate(lengths):
        _close(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], tol)
    written = []
    for i in range(3):
        for p in range(pos[i], pos[i] + lengths[i]):
            if p // PTOK < 2:
                written.append((tables[i, p // PTOK], p % PTOK))
    if quant:
        for got_pool, want_pool, old in zip(tensors, want[1:], pools):
            g, r = got_pool.numpy(), np.asarray(want_pool)
            if g.dtype == np.int8:
                assert np.abs(g[:TRASH].astype(int)
                              - r[:TRASH].astype(int)).max() <= 1
            else:
                _close(g[:TRASH], r[:TRASH])
            keep = np.ones(g.shape[:2], bool)
            for page, off in written:
                keep[page, off] = False
            keep[TRASH] = False
            np.testing.assert_array_equal(g[keep], old[keep])
    else:
        _check_pools(tensors, want[1:], pools, written)


@pytest.mark.parametrize("entry", ["prefill", "decode"])
def test_int8_pools(entry):
    """int8 pages with f32 scale pools: rows quantize on the write and
    dequantize on the gather, as the reference's."""
    rng = np.random.default_rng(10)
    ref, port = _attention()
    kf, vf = _pools(rng)
    kq, ks = (np.asarray(a) for a in ref._kv_quantize(kf))
    vq, vs = (np.asarray(a) for a in ref._kv_quantize(vf))
    ws = _weights(rng)
    kt, vt, kst, vst = _t(kq, vq, ks, vs)
    if entry == "prefill":
        table = np.asarray([2, 0, TRASH], np.int32)
        x = rng.normal(0, 1, (1, 8, D)).astype(np.float32)
        want = _ref(ref.xla_prefill_paged, x, kq, vq, table, np.int32(1),
                    np.int32(6), *ws, k_scale=ks, v_scale=vs)
        got = port.prefill_paged(_t(x)[0], kt, vt, torch.from_numpy(table),
                                 torch.tensor(1), torch.tensor(6), *_t(*ws),
                                 k_scale=kst, v_scale=vst)
        rows = slice(0, 6)
        y_got, y_want = got[0][:, rows], np.asarray(want[0])[:, rows]
    else:
        tables = np.asarray([[1, 4, TRASH], [TRASH] * 3], np.int32)
        x = rng.normal(0, 1, (2, 1, D)).astype(np.float32)
        pos = np.asarray([5, 0], np.int32)
        want = _ref(ref.xla_decode_step_paged, x, kq, vq, tables, pos,
                    *ws, k_scale=ks, v_scale=vs)
        got = port.decode_step_paged(_t(x)[0], kt, vt,
                                     *_t(tables, pos), *_t(*ws),
                                     k_scale=kst, v_scale=vst)
        y_got, y_want = got[0][:1], np.asarray(want[0])[:1]
    assert got[1] is kt and got[3] is kst
    _close(y_got.numpy(), y_want, INT8_TOL)
    assert kt.dtype == torch.int8 and kst.dtype == torch.float32
    for g, r in zip(got[1:], want[1:]):
        g, r = g.numpy(), np.asarray(r)
        if g.dtype == np.int8:
            assert np.abs(g[:TRASH].astype(int)
                          - r[:TRASH].astype(int)).max() <= 1
        else:
            _close(g[:TRASH], r[:TRASH])


def test_kv_quantize_bit_for_bit_rounding_half_to_even():
    rng = np.random.default_rng(11)
    rows = rng.normal(0, 2, (3, 5, H, 16)).astype(np.float32)
    # halfway cases: with a row max of 127, q = rows exactly, so .5
    # values round to the even neighbour
    rows[0, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    rows[0, 0, 1] = 0.0  # an all-zero row takes the 1e-8 floor
    ref, port = _attention()
    q_ref, s_ref = (np.asarray(a) for a in ref._kv_quantize(rows))
    q, s = port._kv_quantize(torch.from_numpy(rows))
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    assert q.dtype == torch.int8
    assert list(q.numpy()[0, 0, 0, :4]) == [127, 2, -4, 0]


# ----------------------------------------------------------------------
# the head as a pure function
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cls,final", [(All2AllSoftmax, True),
                                       (All2AllTanh, False)])
def test_head_of_explicit_weights_is_the_units_forward(cls, final):
    rng = np.random.default_rng(12)
    unit = cls((D,), torch.float32, output_sample_shape=5)
    unit.init_params("cpu")
    x = torch.from_numpy(rng.normal(0, 1, (3, D)).astype(np.float32))
    got = unit.head(x, unit.weights.detach(), unit.bias.detach(),
                    final=final)
    want = unit._logits(x) if final else unit.forward(x)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())
    assert unit.head(x, unit.weights.detach(), None, final=True).shape \
        == (3, 5)
