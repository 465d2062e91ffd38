"""The port's positional encoding, ``to_sequence`` and ``last_token``
units against the reference, on the CPU.

Each forward and its backward run on the same seeded inputs through the
reference's ``numpy_run`` and ``xla_run`` and through the port's units
called as modules (``device="cpu"``).  The positional table is built in
numpy f32 in both packages, so it must be bit-equal; the reshapes, the
last-position select and their adjoints move values without arithmetic,
so they must be exact too; the encoding's f32 add is exact to the bit
as well (one f32 add of the same operands).  In bf16 mode the outputs
are rounded once to bf16, at the same point as the reference's.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice, XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.ops import pos_encoding as ref_pe
from znicz_tpu.ops import seq_reshape as ref_seq
from znicz_tpu_torch.models.layers import layer_type
from znicz_tpu_torch.ops import pos_encoding, seq_reshape
from znicz_tpu_torch.ops.nn_units import WeightlessGradientUnit, gd_for
from znicz_tpu_torch.utils.config import reset_root

RNG = np.random.default_rng(71)


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _reference(fwd_cls, gd_cls, x, err, device, **kwargs):
    """The reference's pair on ``device``: (y, err_input)."""
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    fwd = fwd_cls(wf, **kwargs)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=device)
    err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = gd_cls(wf)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output")
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=device)
    fwd.run()
    bwd.run()
    fwd.output.map_read()
    bwd.err_input.map_read()
    return (np.asarray(fwd.output.mem, np.float32),
            np.asarray(bwd.err_input.mem, np.float32))


def _port(cls, x, err, dtype=torch.float32, **kwargs):
    fwd = cls(x.shape[1:], dtype, **kwargs)
    fwd.init_params("cpu")
    bwd = gd_for(cls)(fwd)
    xt = torch.from_numpy(x).to(fwd.act_store_dtype)
    y = fwd(xt)
    e = bwd.run(xt, torch.from_numpy(err).to(fwd.act_store_dtype), y)
    return y.float().numpy(), e.float().numpy()


@pytest.mark.parametrize("t,d", [(7, 10), (64, 32), (5, 1)])
def test_table_is_the_references_bit_for_bit(t, d):
    np.testing.assert_array_equal(pos_encoding.sinusoid_table(t, d),
                                  ref_pe.sinusoid_table(t, d))
    unit = pos_encoding.PositionalEncoding((t, d), scale=0.3)
    assert unit._table.dtype == torch.float32
    np.testing.assert_array_equal(unit._table.numpy(),
                                  0.3 * ref_pe.sinusoid_table(t, d))
    np.testing.assert_array_equal(unit.table_to(2 * t, d)[:t],
                                  unit._table.numpy())


CASES = {
    "pos_encoding": (pos_encoding.PositionalEncoding,
                     ref_pe.PositionalEncoding, ref_pe.GDPositionalEncoding,
                     (3, 9, 12), (3, 9, 12), {"scale": 0.5}),
    "to_sequence": (seq_reshape.ToSequence, ref_seq.ToSequence,
                    ref_seq.GDToSequence, (2, 4, 5, 6), (2, 20, 6), {}),
    "last_token": (seq_reshape.LastToken, ref_seq.LastToken,
                   ref_seq.GDLastToken, (3, 7, 8), (3, 8), {}),
}


@pytest.mark.parametrize("backend", ["numpy_run", "xla_run"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pair_matches_the_reference(name, backend):
    cls, ref_cls, ref_gd, x_shape, y_shape, kwargs = CASES[name]
    x = RNG.normal(size=x_shape).astype(np.float32)
    err = RNG.normal(size=y_shape).astype(np.float32)
    device = NumpyDevice() if backend == "numpy_run" else XLADevice()
    want_y, want_e = _reference(ref_cls, ref_gd, x, err, device, **kwargs)
    got_y, got_e = _port(cls, x, err, **kwargs)
    assert got_y.shape == y_shape and got_e.shape == x_shape
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_e, want_e)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_rounds_where_the_reference_does(name):
    """bf16 mode: inputs and errors stored in bf16, the output rounded
    once from the f32 result (the reference's XLA path in bf16)."""
    from znicz_tpu.utils.config import root as ref_root
    cls, ref_cls, ref_gd, x_shape, y_shape, kwargs = CASES[name]
    x = RNG.normal(size=x_shape).astype(np.float32)
    err = RNG.normal(size=y_shape).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16().float().numpy()
    eb = torch.from_numpy(err).bfloat16().float().numpy()
    ref_root.common.precision_type = "bfloat16"
    try:
        want_y, want_e = _reference(ref_cls, ref_gd, xb, eb, XLADevice(),
                                    **kwargs)
    finally:
        ref_root.common.precision_type = "float32"
    got_y, got_e = _port(cls, x, err, torch.bfloat16, **kwargs)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_e, want_e)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_types_and_weightless_pairs(name):
    cls, _, _, x_shape, y_shape, kwargs = CASES[name]
    assert layer_type(name) is cls
    gd_cls = gd_for(cls)
    assert issubclass(gd_cls, WeightlessGradientUnit)
    fwd = cls(x_shape[1:], torch.float32, **kwargs)
    fwd.init_params("cpu")
    assert not list(fwd.parameters()) and fwd.EXPORT_PARAMS == ()
    assert fwd.output_shape == y_shape[1:]
    # the first layer's backward gives no error, and takes no rate
    bwd = gd_cls(fwd, learning_rate=0.5, need_err_input=False)
    x = torch.zeros(x_shape)
    assert bwd.run(x, torch.zeros(y_shape), fwd(x)) is None
    assert bwd.lr_state is None and not list(bwd.buffers())


def test_shape_checks():
    with pytest.raises(ValueError, match="time, features"):
        pos_encoding.PositionalEncoding((4,))
    with pytest.raises(ValueError, match="time, features"):
        seq_reshape.LastToken((4, 5, 6))
    with pytest.raises(ValueError, match="rank"):
        seq_reshape.ToSequence((4,))


def test_conv_to_sequence_workflow_matches_the_reference():
    """conv → to_sequence → attention → softmax (the ViT-style bridge)
    trained three steps in both packages from one seed: every parameter
    and momentum within 1e-5 of its largest |value| (f32, the bar of
    ``tests/test_torch_training.py``)."""
    from znicz_tpu.loader.fullbatch import ArrayLoader as RefLoader
    from znicz_tpu.models.standard_workflow import \
        StandardWorkflow as RefWorkflow
    from znicz_tpu.utils import prng as ref_prng
    from znicz_tpu.utils.config import root as ref_root
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng

    rng = np.random.default_rng(17)
    x = rng.normal(size=(24, 6, 6, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=24).astype(np.int32)
    gd = {"learning_rate": 0.05, "gradient_moment": 0.9}
    layers = [{"type": "conv", "->": {"n_kernels": 8, "kx": 3, "ky": 3,
                                      "padding": 1}, "<-": gd},
              {"type": "to_sequence", "->": {}},
              {"type": "attention", "->": {"n_heads": 1}, "<-": gd},
              {"type": "softmax", "->": {"output_sample_shape": 4},
               "<-": gd}]

    def loader(cls):
        return lambda w: cls(w, train_data=x, train_labels=y,
                             minibatch_size=8)

    ref_root.common.engine.anomaly_guard = False
    ref_prng.seed_all(5)
    ref = RefWorkflow(name="seq_conv", loader_factory=loader(RefLoader),
                      layers=layers, decision_config={"max_epochs": 9})
    ref._max_fires = 10 ** 6
    ref.initialize(device=XLADevice())
    prng.seed_all(5)
    port = StandardWorkflow(name="seq_conv",
                            loader_factory=loader(ArrayLoader),
                            layers=layers, decision_config={"max_epochs": 9})
    port.initialize(device="cpu")
    assert port.forwards[1].output_shape == (36, 8)
    for _ in range(3):
        ref.loader._fire()
        ref._region_unit._fire()
        ref.decision._fire()
        port.step()
    for ref_unit, unit in zip([*ref.forwards, *ref.gds],
                              [*port.forwards, *port.gds]):
        for name, t in [*unit.named_parameters(recurse=False),
                        *unit.named_buffers(recurse=False)]:
            vec = ref_unit.__dict__[name]
            vec.map_read()
            want = np.asarray(vec.mem, np.float32)
            np.testing.assert_allclose(
                t.detach().numpy(), want, rtol=0,
                atol=1e-5 * np.abs(want).max(), err_msg=f"{unit.name}.{name}")
