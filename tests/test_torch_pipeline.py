"""The temporal pipeline (counterpart of ``tests/test_pipeline.py``):
the schedule builders against the reference's, and
``StandardWorkflow.run_pipelined`` against ``run_accumulated`` and
against the reference's ``run_pipelined``.

The reference's exact-arithmetic chain (data in {−1, 0, 1}, dyadic
k/16 weights, learning rate 2⁻⁴, momentum ½, power-of-two batches) makes
every float of the accumulate/apply split exact, so pipelined and
accumulated runs agree to the bit (the reference's pipelined run within
1e-6: its four-layer chain's second step is not exact); the
attention LM chain is held bit for bit to the unstaged accumulated run
(the same kernels on the same microbatches in the same order).  The
graphed executor's bookkeeping runs on the CPU with a stand-in for the
CUDA graph API; its numbers are the card's (``chip_smoke.py``).
"""

import contextlib

import numpy as np
import pytest
import torch

from znicz_tpu.parallel import pipeline as ref_pp
from znicz_tpu_torch.parallel import pipeline as pp
from znicz_tpu_torch.utils.config import reset_root, root


@pytest.fixture(autouse=True)
def fresh_root():
    reset_root()
    yield
    reset_root()


@pytest.mark.parametrize("n_layers,n_stages", [
    (4, 4), (5, 2), (7, 3), (2, 3), (4, 0), (1, 1)])
def test_split_stages_is_the_reference(n_layers, n_stages):
    try:
        want = ref_pp.split_stages(n_layers, n_stages)
    except ValueError:
        with pytest.raises(ValueError, match="cannot split"):
            pp.split_stages(n_layers, n_stages)
        return
    assert pp.split_stages(n_layers, n_stages) == want


@pytest.mark.parametrize("kind", ["1f1b", "gpipe"])
@pytest.mark.parametrize("n_stages,n_micro", [
    (1, 2), (2, 4), (4, 4), (4, 8), (3, 5)])
def test_build_schedule_is_the_reference(kind, n_stages, n_micro):
    ticks = pp.build_schedule(n_stages, n_micro, kind)
    assert ticks == ref_pp.build_schedule(n_stages, n_micro, kind)
    assert len(ticks) == 2 * (n_micro + n_stages - 1)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (1, 8), (4, 4),
                                              (2, 4)])
def test_bubble_fraction_is_the_reference(n_stages, n_micro):
    assert pp.bubble_fraction(n_stages, n_micro) \
        == ref_pp.bubble_fraction(n_stages, n_micro)


def test_unknown_schedule_kind_is_hard_error():
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        pp.build_schedule(2, 4, "interleaved")


N, D = 64, 8
_rs = np.random.RandomState(7)
LINEAR_DATA = _rs.randint(-1, 2, size=(N, D)).astype(np.float32)


def _dyadic(shape, rs):
    return (rs.randint(-8, 9, size=shape) / 16.0).astype(np.float32)


def _linear(pkg, name, minibatch_size, grad_accum, n_layers=1, epochs=1):
    """The reference test's exact-arithmetic autoencoder, in ``pkg``
    ("port" or "reference"), on one CPU device."""
    layers = [{"type": "all2all", "->": {"output_sample_shape": D},
               "<-": {"learning_rate": 0.0625, "gradient_moment": 0.5}}
              ] * n_layers
    rs = np.random.RandomState(23)
    if pkg == "port":
        from znicz_tpu_torch.loader.fullbatch import ArrayLoader
        from znicz_tpu_torch.models.standard_workflow import \
            StandardWorkflow
        from znicz_tpu_torch.utils import prng
        root.common.engine.grad_accum = grad_accum
        prng.seed_all(17)
        wf = StandardWorkflow(
            name=name, loader_factory=lambda w: ArrayLoader(
                w, train_data=LINEAR_DATA, minibatch_size=minibatch_size),
            layers=layers, loss="mse", decision_config={"max_epochs": epochs})
        wf._max_fires = 100_000
        wf.initialize(device="cpu")
        with torch.no_grad():
            for fwd in wf.forwards:
                for t in (fwd.weights, fwd.bias):
                    t.copy_(torch.from_numpy(_dyadic(tuple(t.shape), rs)))
        return wf
    from znicz_tpu.backends import XLADevice
    from znicz_tpu.loader.fullbatch import ArrayLoader
    from znicz_tpu.models.standard_workflow import StandardWorkflow
    from znicz_tpu.utils import prng
    from znicz_tpu.utils.config import root as ref_root
    ref_root.common.engine.grad_accum = grad_accum
    ref_root.common.engine.anomaly_guard = False
    ref_root.common.engine.sdc_fingerprints = False
    prng.seed_all(17)
    wf = StandardWorkflow(
        name=name, loader_factory=lambda w: ArrayLoader(
            w, train_data=LINEAR_DATA, minibatch_size=minibatch_size),
        layers=layers, loss="mse", decision_config={"max_epochs": epochs})
    wf._max_fires = 100_000
    wf.initialize(device=XLADevice())
    for fwd in wf.forwards:
        for vec in (fwd.weights, fwd.bias):
            vec.map_write()
            vec.mem[...] = _dyadic(vec.mem.shape, rs)
    return wf


def _params(wf):
    out = []
    for fwd in wf.forwards:
        for name in ("weights", "bias"):
            t = getattr(fwd, name)
            if isinstance(t, torch.Tensor):
                out.append(t.detach().numpy().copy())
            else:
                t.map_read()
                out.append(np.array(t.mem, copy=True))
    return out


def _assert_bitwise(ref, got, what):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: param[{i}]")


def test_accum_step_bitwise_equals_fused_batch():
    wf_f = _linear("port", "pp_fused", 32, 1)
    wf_f.run()
    wf_a = _linear("port", "pp_accum", 8, 4)
    wf_a.run_accumulated()
    _assert_bitwise(_params(wf_f), _params(wf_a), "accum vs fused")


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pipeline_4stage_bitwise_equals_unstaged(schedule):
    wf_a = _linear("port", "pp4_accum", 8, 4, n_layers=4)
    wf_a.run_accumulated()
    wf_p = _linear("port", "pp4_pipe", 8, 4, n_layers=4)
    wf_p.run_pipelined(n_stages=4, schedule=schedule)
    _assert_bitwise(_params(wf_a), _params(wf_p), f"{schedule} vs accum")
    ex = wf_p._pipeline
    assert ex.n_stages == 4 and ex.n_micro == 4
    assert len(ex.ticks) == 14  # 2·(M + K − 1)
    assert not ex._ctx, "microbatch contexts leaked across steps"
    assert ex.last_makespan > 0.0 and ex.last_bubble_seconds >= 0.0
    from znicz_tpu_torch.observe import metrics
    assert metrics.pipeline_stages("pp4_pipe").value == 4
    assert metrics.pipeline_bubble_seconds("pp4_pipe").value > 0.0


def test_pipeline_equals_the_reference_pipeline():
    """The port's 1F1B run and the reference's, from the same dyadic
    weights, within 1e-6: the four-layer chain's second optimizer step
    outgrows the exact-dyadic budget (the reference's own note), and the
    two packages sum in different orders."""
    ref = _linear("reference", "ppr", 8, 4, n_layers=4)
    ref.run_pipelined(n_stages=4)
    wf = _linear("port", "ppr", 8, 4, n_layers=4)
    wf.run_pipelined(n_stages=4)
    for a, b in zip(_params(ref), _params(wf)):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def _lm(name):
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    n, t, d, c = 64, 6, 8, 3
    rng = np.random.default_rng(9)
    data = rng.normal(0, 0.3, size=(n, t, d)).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    gd = {"learning_rate": 0.0625, "gradient_moment": 0.5}
    root.common.engine.grad_accum = 4
    prng.seed_all(17)
    wf = StandardWorkflow(
        name=name,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data, train_labels=labels, minibatch_size=8),
        layers=[
            {"type": "attention", "->": {"n_heads": 2}, "<-": gd},
            {"type": "layer_norm", "->": {}, "<-": gd},
            {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": gd},
            {"type": "softmax", "->": {"output_sample_shape": c},
             "<-": gd}],
        decision_config={"max_epochs": 2})
    wf._max_fires = 100_000
    wf.initialize(device="cpu")
    return wf


def _lm_params(wf):
    return [getattr(fwd, name).detach().numpy().copy()
            for fwd in wf.forwards for name in fwd.EXPORT_PARAMS
            if getattr(fwd, name, None) is not None]


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_attention_lm_bitwise_equals_accum(n_stages):
    """The LM chain (attention → layer_norm → tanh → softmax) over 2 and
    4 stages, two epochs: the attention unit's kept graph travels with
    its microbatch."""
    wf_a = _lm("pplm_accum")
    wf_a.run_accumulated()
    ref = _lm_params(wf_a)
    assert len(ref) == 10
    wf_p = _lm("pplm_pipe")
    wf_p.run_pipelined(n_stages=n_stages)
    _assert_bitwise(ref, _lm_params(wf_p), "LM pipe vs accum")
    assert wf_p.decision.epoch_n_err is not None


def test_stage_tags_reach_the_partition_table():
    wf = _linear("port", "pp_tags", 8, 4, n_layers=4)
    ex = pp.PipelineExecutor(wf, n_stages=4, n_micro=4)
    stages = [s for _, pl in wf.partition.rules
              for s in ([pl.index] if isinstance(pl, pp.Stage) else [])]
    assert sorted(set(stages)) == [0, 1, 2, 3]
    assert len(ex.fwd_regions) == len(ex.bwd_regions) == 4
    assert ex.fwd_regions[0].units[0] is wf.loader
    assert ex.bwd_regions[-1].units[0] is wf.evaluator


def test_ragged_train_set_is_hard_error():
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    root.common.engine.grad_accum = 4
    wf = StandardWorkflow(
        name="pp_ragged",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=np.zeros((40, 4), np.float32), minibatch_size=8),
        layers=[{"type": "all2all", "->": {"output_sample_shape": 4},
                 "<-": {"learning_rate": 0.0625}}],
        loss="mse", decision_config={"max_epochs": 1})
    wf.initialize(device="cpu")
    with pytest.raises(RuntimeError, match="does not divide"):
        wf.run_accumulated()
    with pytest.raises(RuntimeError, match="does not divide"):
        wf.run_pipelined(n_stages=1, microbatches=4)


def test_pipeline_rejects_single_microbatch():
    wf = _linear("port", "pp_single", 8, 1, n_layers=2)
    with pytest.raises(ValueError, match="microbatch"):
        pp.PipelineExecutor(wf, n_stages=2, n_micro=1)


def test_graphed_executor_captures_each_op_once(monkeypatch):
    """The card's bookkeeping with a stand-in for the CUDA graph API (a
    capture runs the members, a replay runs nothing): the first step
    captures one graph an op (2·K·M), a warm-up reads its microbatch's
    warm-up bindings and a capture its captured ones, and later steps
    only replay, each replay binding its microbatch's captured
    tensors."""
    replays = []

    class Graph:
        def replay(self):
            replays.append(self)

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: _Event())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(pp.PipelineExecutor, "graphed",
                        property(lambda self: True))
    wf = _linear("port", "pp_graphed", 8, 4, n_layers=2)
    ex = pp.PipelineExecutor(wf, n_stages=2, n_micro=4)
    for _ in range(4):
        wf.loader.run()
    ex.run_step()
    assert ex.captures == 2 * 2 * 4 and not replays
    assert set(ex._static) == {0, 1, 2, 3} and not ex._ctx
    # each microbatch's captured output of stage 0 is its own tensor
    outs = {m: ex._static[m][id(wf.forwards[0]), "output"][2]
            for m in range(4)}
    assert len({id(t) for t in outs.values()}) == 4
    for _ in range(4):
        wf.loader.run()
    ex.run_step()
    assert len(replays) == 16 and ex.captures == 16
    assert wf.forwards[0].output is outs[3]


class _Event:
    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0
