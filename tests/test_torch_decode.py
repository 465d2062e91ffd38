"""Decode serving in the port (``znicz_tpu_torch.serving.decode``) on the
CPU: the tests of the reference's ``tests/test_decode.py`` through the
port's ``DecodeEngine``, on the same bundles.

The bundles are the reference's own fixtures: the tiny attention LM of
``benchmarks/serve_bench.py``'s ``train_and_export_lm`` and the tiny
LSTM LM of ``tests/test_decode.py``, trained by the reference.  The
ground truth is the reference test's step-by-step numpy oracle (copied
here): at each generated position it reruns the whole causal chain over
the sequence so far and takes the argmax.  Token ids are integers, so
the port's engine must give the oracle's exactly; on some prompts it is
also held to the reference's ``DecodeEngine``.  "Zero compiles" is here
zero new programs after ``warmup``: ``compile_count`` and
``programs_live`` stay flat.  A bundle the port exports decodes in the
reference to the same tokens, and the reference's in the port.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from znicz_tpu.ops.pos_encoding import sinusoid_table
from znicz_tpu.serving import DecodeEngine as RefEngine
from znicz_tpu_torch.export import ExportedModel
from znicz_tpu_torch.serving import (DecodeEngine, DecodeModel, Overloaded,
                                     QueueFull)
from znicz_tpu_torch.serving.batcher import DeadlineExceeded
from znicz_tpu_torch.utils.config import reset_root

VOCAB = 12


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


# ----------------------------------------------------------------------
# bundles trained by the reference (one training run per module)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_bundle(tmp_path_factory):
    """Tiny attention LM: embedding → pos_encoding → causal attention →
    last_token → softmax."""
    from benchmarks.serve_bench import train_and_export_lm
    path = str(tmp_path_factory.mktemp("decode") / "lm.npz")
    return train_and_export_lm(path, vocab=VOCAB, epochs=3)


def train_rnn_bundle(path: str, units: int = 20, epochs: int = 2,
                     name: str = "tiny_rnn_lm") -> str:
    """The reference test's tiny LSTM LM: embedding → lstm
    (return_sequence=False) → softmax, trained by the reference."""
    from znicz_tpu.backends import XLADevice
    from znicz_tpu.loader.fullbatch import ArrayLoader
    from znicz_tpu.models.standard_workflow import StandardWorkflow
    from znicz_tpu.utils import prng

    rng = np.random.default_rng(3)
    data = rng.integers(0, VOCAB, size=(128, 6)).astype(np.float32)
    labels = (data[:, -1].astype(np.int32) + 1) % VOCAB
    prng.seed_all(7)
    wf = StandardWorkflow(
        name=name,
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=32),
        layers=[
            {"type": "embedding", "->": {"vocab_size": VOCAB, "dim": 12},
             "<-": {"learning_rate": 0.1}},
            {"type": "lstm", "->": {"units": units},
             "<-": {"learning_rate": 0.1}},
            {"type": "softmax", "->": {"output_sample_shape": VOCAB},
             "<-": {"learning_rate": 0.1}},
        ],
        decision_config={"max_epochs": epochs})
    wf._max_fires = 10 ** 6
    wf.initialize(device=XLADevice())
    wf.run()
    wf.export_forward(path)
    return path


@pytest.fixture(scope="module")
def rnn_bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decode") / "rnn_lm.npz")
    return train_rnn_bundle(path)


def params_of(bundle):
    with np.load(bundle) as b:
        manifest = json.loads(bytes(b["manifest"]).decode())
        params = {k: np.array(b[k]) for k in b.files if k != "manifest"}
    return manifest, params


# ----------------------------------------------------------------------
# numpy oracles (the reference test's): the whole chain, every step
# ----------------------------------------------------------------------
def attn_oracle_logits(man, P, seq):
    ids = np.asarray(seq, np.int32)
    x = P["layer0_weights"][ids][None].astype(np.float32)
    t, d = x.shape[1], x.shape[2]
    x = x + sinusoid_table(t, d)
    qkv = x.reshape(t, d) @ P["layer2_weights"] + P["layer2_bias"]
    h = man["layers"][2]["config"]["n_heads"]
    dh = d // h
    qkv = qkv.reshape(1, t, 3 * d)
    q = qkv[..., :d].reshape(1, t, h, dh)
    k = qkv[..., d:2 * d].reshape(1, t, h, dh)
    v = qkv[..., 2 * d:].reshape(1, t, h, dh)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
    mask = np.arange(t)[:, None] >= np.arange(t)[None, :]
    s = np.where(mask[None, None], s, -1e30)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", p, v)
    y = o.reshape(t, d) @ P["layer2_weights_out"] + P["layer2_bias_out"]
    feat = y.reshape(t, d)[-1]
    return feat @ P["layer4_weights"] + P["layer4_bias"]


def lstm_oracle_logits(man, P, seq):
    def sig(z):
        return 1.0 / (1.0 + np.exp(-z))

    w, b = P["layer1_weights"], P["layer1_bias"]
    hsz = w.shape[1] // 4
    h = np.zeros((1, hsz), np.float32)
    c = np.zeros((1, hsz), np.float32)
    for t in seq:
        x = P["layer0_weights"][int(t)][None].astype(np.float32)
        z = np.concatenate([x, h], 1) @ w + b
        i, f = sig(z[:, :hsz]), sig(z[:, hsz:2 * hsz])
        g, o = np.tanh(z[:, 2 * hsz:3 * hsz]), sig(z[:, 3 * hsz:])
        c = f * c + i * g
        h = o * np.tanh(c)
    return (h @ P["layer2_weights"] + P["layer2_bias"])[0]


def oracle_greedy(logits_fn, man, P, prompt, n):
    seq = [int(t) for t in prompt]
    out = []
    for _ in range(n):
        tok = int(np.argmax(logits_fn(man, P, seq)))
        out.append(tok)
        seq.append(tok)
    return out


def engine(bundle, **kwargs) -> DecodeEngine:
    return DecodeEngine(bundle, device="cpu", **kwargs)


def ref_tokens(bundle, prompts, n, **kwargs):
    """The reference's DecodeEngine's greedy tokens."""
    with RefEngine(bundle, max_new_tokens=n, **kwargs) as eng:
        return [list(eng.generate(p, timeout=300)) for p in prompts]


# ----------------------------------------------------------------------
# manifest metadata
# ----------------------------------------------------------------------
def test_manifest_records_kind_and_sequence(lm_bundle):
    man, _ = params_of(lm_bundle)
    assert man["kind"] == "lm"
    seq = man["sequence"]
    assert seq["vocab"] == VOCAB and seq["train_t"] == 8
    assert seq["cache"] == [{"layer": 2, "kind": "attention", "heads": 2,
                             "head_dim": 8, "features": 16}]
    model = ExportedModel.load(lm_bundle, device="cpu")
    assert model.kind == "lm" and model.sequence == seq
    assert model.decode_meta == {}


def test_manifest_scorer_kind(tmp_path):
    from benchmarks.serve_bench import train_and_export
    path = str(tmp_path / "fc.npz")
    train_and_export(path, epochs=1)
    model = ExportedModel.load(path, device="cpu")
    assert model.kind == "scorer" and model.sequence is None
    with pytest.raises(ValueError, match="'scorer'"):
        DecodeModel(model)


def test_legacy_bundle_rederives_metadata(lm_bundle):
    """A bundle without ``kind``/``sequence`` decodes unchanged: the
    metadata re-derives from the layer table."""
    man, params = params_of(lm_bundle)
    legacy = {k: v for k, v in man.items() if k not in ("kind", "sequence")}
    model = ExportedModel(legacy, params, device="cpu")
    assert model.kind == "lm"
    assert model.sequence["vocab"] == VOCAB
    assert model.sequence["cache"][0]["kind"] == "attention"
    with DecodeEngine(model, max_slots=2, max_t=32, max_prompt=8,
                      prompt_align=4, max_new_tokens=4) as eng:
        got = list(eng.generate(np.array([1, 2, 3]), timeout=120))
    assert got == oracle_greedy(attn_oracle_logits, man, params,
                                [1, 2, 3], 4)


def test_lstm_sequence_metadata(rnn_bundle):
    model = ExportedModel.load(rnn_bundle, device="cpu")
    assert model.kind == "lm"
    assert model.sequence["cache"] == [
        {"layer": 1, "kind": "lstm", "hidden": 20}]


# ----------------------------------------------------------------------
# greedy decode ≡ numpy oracle ≡ the reference's engine
# ----------------------------------------------------------------------
def test_greedy_attention_engine_vs_oracle(lm_bundle):
    man, P = params_of(lm_bundle)
    geometry = dict(max_slots=4, max_t=32, max_prompt=16, prompt_align=4)
    prompts = [(np.arange(plen) * 3) % VOCAB for plen in (1, 3, 5, 11)]
    with engine(lm_bundle, max_new_tokens=8, **geometry) as eng:
        got = [list(eng.generate(p, timeout=120)) for p in prompts]
    for p, g in zip(prompts, got):
        assert g == oracle_greedy(attn_oracle_logits, man, P, p, 8), len(p)
    assert got == ref_tokens(lm_bundle, prompts, 8, **geometry)


def test_greedy_lstm_engine_vs_oracle(rnn_bundle):
    man, P = params_of(rnn_bundle)
    geometry = dict(max_slots=2, max_t=32, max_prompt=8, prompt_align=4)
    prompts = [(np.arange(plen) * 2 + 1) % VOCAB for plen in (1, 4, 7)]
    with engine(rnn_bundle, max_new_tokens=6, **geometry) as eng:
        got = [list(eng.generate(p, timeout=120)) for p in prompts]
    for p, g in zip(prompts, got):
        assert g == oracle_greedy(lstm_oracle_logits, man, P, p, 6), len(p)
    assert got == ref_tokens(rnn_bundle, prompts, 6, **geometry)


def test_continuous_admission_matches_sequential_oracle(lm_bundle):
    """More prompts than slots at once: admission mid-decode, lanes at
    ragged depths, every result the one-at-a-time oracle's."""
    man, P = params_of(lm_bundle)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 13, size=10)]
    budgets = [int(b) for b in rng.integers(3, 12, size=10)]
    with engine(lm_bundle, max_slots=3, max_t=32, max_prompt=16,
                prompt_align=4) as eng:
        futs = [eng.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        results = [list(f.result(timeout=240)) for f in futs]
    for i, (p, b, got) in enumerate(zip(prompts, budgets, results)):
        assert got == oracle_greedy(attn_oracle_logits, man, P, p, b), i


def test_static_admission_same_tokens(lm_bundle):
    man, P = params_of(lm_bundle)
    prompts = [np.array([2, 5]), np.array([7]), np.array([1, 2, 3, 4]),
               np.array([9, 0, 4])]
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=6,
                admission="static") as eng:
        futs = [eng.submit(p) for p in prompts]
        for p, f in zip(prompts, futs):
            assert list(f.result(timeout=240)) == oracle_greedy(
                attn_oracle_logits, man, P, p, 6)


# ----------------------------------------------------------------------
# the cache slots
# ----------------------------------------------------------------------
def test_slot_reuse_after_eviction_is_clean(lm_bundle):
    """A long earlier tenant's rows are unreachable for a shorter one."""
    man, P = params_of(lm_bundle)
    long_p = (np.arange(14) * 5) % VOCAB
    short_p = np.array([4, 1])
    with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=10) as eng:
        first = list(eng.generate(long_p, timeout=240))
        second = list(eng.generate(short_p, timeout=240))
    assert first == oracle_greedy(attn_oracle_logits, man, P, long_p, 10)
    assert second == oracle_greedy(attn_oracle_logits, man, P, short_p,
                                   10), "a reused slot leaked rows"


def test_eos_evicts_slot(lm_bundle):
    man, P = params_of(lm_bundle)
    prompt = np.array([3, 4, 5])
    full = oracle_greedy(attn_oracle_logits, man, P, prompt, 8)
    idx = next((i for i in range(1, len(full)) if full[i] not in full[:i]),
               0)
    eos = full[idx]
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=8, eos_token=eos) as eng:
        got = list(eng.generate(prompt, timeout=240))
        assert got == full[:idx + 1]
        assert eng.model.cache.free_slots == 2


def test_max_t_page_boundary_force_finishes(lm_bundle):
    with engine(lm_bundle, max_slots=1, max_t=16, max_prompt=8,
                prompt_align=4, max_new_tokens=1000) as eng:
        got = eng.generate(np.array([1, 2, 3, 4, 5]), timeout=240)
    assert len(got) == 16 - 5 + 1


def test_sampled_continuations_seeded(lm_bundle):
    prompt = np.array([6, 7])

    def gen(seed):
        with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                    prompt_align=4, max_new_tokens=12, temperature=1.0,
                    seed=seed) as eng:
            return list(eng.generate(prompt, timeout=240))

    a, b, c = gen(5), gen(5), gen(6)
    assert a == b
    assert all(0 <= t < VOCAB for t in a)
    assert a != c


# ----------------------------------------------------------------------
# no new program once warmed
# ----------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
def test_warmed_decode_loop_makes_no_new_program(lm_bundle, paged):
    with engine(lm_bundle, max_slots=4, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=9, paged=paged) as eng:
        assert eng.warmup_compiles == eng.model.programs_live > 0
        before = eng.model.compile_count
        rng = np.random.default_rng(4)
        futs = [eng.submit(rng.integers(0, VOCAB, size=int(n)))
                for n in rng.integers(1, 16, size=9)]
        assert sum(len(f.result(timeout=240)) for f in futs) >= 9 * 9
        assert eng.model.compile_count == before
        assert eng.model.programs_live == eng.warmup_compiles
        st = eng.stats()
        assert st["programs_compiled"] == eng.warmup_compiles
        assert st["captures"] == 0 and st["graphed"] is False


# ----------------------------------------------------------------------
# resilience: the TTFT deadline and the breaker
# ----------------------------------------------------------------------
def test_ttft_deadline_evicts_queued_prompt(lm_bundle):
    gate = threading.Event()
    with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=4) as eng:
        real_prefill = eng.model.run_prefill

        def slow_prefill(tokens, slot, start=0):
            gate.wait(timeout=30)
            return real_prefill(tokens, slot, start)

        eng.model.run_prefill = slow_prefill
        blocker = eng.submit(np.array([1]))
        doomed = eng.submit(np.array([2]), deadline_ms=30.0)
        survivor = eng.submit(np.array([3]))
        time.sleep(0.15)
        gate.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=60)
        assert blocker.result(timeout=120).shape == (4,)
        assert survivor.result(timeout=120).shape == (4,)
        assert eng.stats()["resilience"]["expired"] == 1


def test_breaker_sheds_new_prompts_while_inflight_drains(lm_bundle):
    with engine(lm_bundle, max_slots=2, max_t=128, max_prompt=8,
                prompt_align=4, max_new_tokens=600,
                breaker_cooldown_ms=60_000.0) as eng:
        inflight = eng.submit(np.array([5, 6]))
        time.sleep(0.01)
        for _ in range(eng._outcomes.maxlen):
            eng._record_outcome(False)
        assert eng.breaker_state == "open"
        with pytest.raises(Overloaded):
            eng.submit(np.array([1]))
        assert eng.stats()["resilience"]["shed"] == 1
        assert len(inflight.result(timeout=300)) > 0
        assert not eng.ready()


def test_breaker_opens_on_consecutive_prefill_failures(lm_bundle):
    with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=3, retry_budget=0,
                breaker_window=4, breaker_min_samples=4,
                breaker_cooldown_ms=50.0) as eng:
        real_prefill = eng.model.run_prefill
        boom = {"on": True}

        def flaky_prefill(tokens, slot, start=0):
            if boom["on"]:
                raise RuntimeError("injected prefill failure")
            return real_prefill(tokens, slot, start)

        eng.model.run_prefill = flaky_prefill
        futs = [eng.submit(np.array([i + 1])) for i in range(4)]
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=60)
        deadline = time.monotonic() + 10
        while eng.breaker_state != "open" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.breaker_state == "open"
        boom["on"] = False
        time.sleep(0.08)
        deadline = time.monotonic() + 10
        tokens = None
        while time.monotonic() < deadline:
            try:
                tokens = eng.generate(np.array([3]), timeout=60)
                break
            except (Overloaded, QueueFull):
                time.sleep(0.02)
        assert tokens is not None and len(tokens) == 3
        assert eng.breaker_state == "closed"


def test_prefill_failure_isolated_to_its_prompt(lm_bundle):
    man, P = params_of(lm_bundle)
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=4, prefix_cache=False,
                retry_budget=0) as eng:
        real_prefill = eng.model.run_prefill

        def poison_prefill(tokens, slot, start=0):
            if tokens[0] == 9:
                raise RuntimeError("poisoned prompt")
            return real_prefill(tokens, slot, start)

        eng.model.run_prefill = poison_prefill
        good1 = eng.submit(np.array([1, 2]))
        bad = eng.submit(np.array([9, 9]))
        good2 = eng.submit(np.array([3]))
        with pytest.raises(RuntimeError):
            bad.result(timeout=60)
        assert list(good1.result(timeout=120)) == oracle_greedy(
            attn_oracle_logits, man, P, [1, 2], 4)
        assert list(good2.result(timeout=120)) == oracle_greedy(
            attn_oracle_logits, man, P, [3], 4)
        assert eng.model.cache.free_slots == 2


# ----------------------------------------------------------------------
# API edges
# ----------------------------------------------------------------------
def test_submit_validation(lm_bundle):
    with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                prompt_align=4) as eng:
        with pytest.raises(ValueError, match="empty"):
            eng.submit(np.array([], np.int32))
        with pytest.raises(ValueError, match="max_prompt"):
            eng.submit(np.arange(9))
        with pytest.raises(DeadlineExceeded):
            eng.submit(np.array([1]), deadline_ms=-1)
    with pytest.raises(RuntimeError, match="not started|shut down"):
        eng.submit(np.array([1]))


def test_queue_backpressure(lm_bundle):
    gate = threading.Event()
    with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=2, max_queue=1) as eng:
        real_prefill = eng.model.run_prefill

        def gated_prefill(tokens, slot, start=0):
            gate.wait(timeout=30)
            return real_prefill(tokens, slot, start)

        eng.model.run_prefill = gated_prefill
        first = eng.submit(np.array([1]))
        time.sleep(0.05)
        second = eng.submit(np.array([2]))
        with pytest.raises(QueueFull):
            eng.submit(np.array([3]))
        gate.set()
        assert first.result(timeout=120) is not None
        assert second.result(timeout=120) is not None
        assert eng.stats()["rejected"] == 1


def test_geometry_validation(lm_bundle):
    model = ExportedModel.load(lm_bundle, device="cpu")
    with pytest.raises(ValueError, match="max_prompt"):
        DecodeModel(model, max_t=16, max_prompt=16)
    with pytest.raises(ValueError, match="ladder top"):
        DecodeModel(model, max_t=32, max_prompt=30, prompt_align=12)
    with pytest.raises(ValueError, match="positions"):
        DecodeModel(model, max_t=16, max_prompt=8).run_decode(
            np.array([1]), np.array([0]), np.array([16]))


# ----------------------------------------------------------------------
# bundles across the packages
# ----------------------------------------------------------------------
def test_port_exported_bundle_decodes_in_the_reference(tmp_path):
    """An LM trained and exported by the port decodes in the reference
    to the port's tokens, and to the oracle's."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.utils import prng
    rng = np.random.default_rng(31)
    start = rng.integers(0, VOCAB, size=128)
    data = ((start[:, None] + np.arange(8)[None]) % VOCAB).astype(np.float32)
    labels = ((start + 8) % VOCAB).astype(np.int32)
    prng.seed_all(31)
    wf = StandardWorkflow(
        name="port_lm",
        loader_factory=lambda w: ArrayLoader(
            w, train_data=data[:96], train_labels=labels[:96],
            valid_data=data[96:], valid_labels=labels[96:],
            minibatch_size=32),
        layers=[{"type": "embedding", "->": {"vocab_size": VOCAB, "dim": 16},
                 "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
                {"type": "pos_encoding", "->": {}},
                {"type": "attention", "->": {"n_heads": 2, "causal": True},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
                {"type": "last_token", "->": {}},
                {"type": "softmax", "->": {"output_sample_shape": VOCAB},
                 "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}],
        decision_config={"max_epochs": 2})
    wf.initialize(device="cpu")
    wf.run()
    path = wf.export_forward(str(tmp_path / "port_lm.npz"))
    man, P = params_of(path)
    geometry = dict(max_slots=2, max_t=32, max_prompt=8, prompt_align=4)
    prompts = [np.array([4]), np.array([1, 2, 3, 4, 5]), np.array([9, 3])]
    with engine(path, max_new_tokens=6, **geometry) as eng:
        got = [list(eng.generate(p, timeout=120)) for p in prompts]
    assert got == ref_tokens(path, prompts, 6, **geometry)
    for p, g in zip(prompts, got):
        assert g == oracle_greedy(attn_oracle_logits, man, P, p, 6)


def test_reference_bundle_decodes_in_the_port_flat_and_paged(lm_bundle):
    """The reference's bundle through the port's flat and paged arms:
    the same tokens as the reference's engine on the flat arm."""
    geometry = dict(max_slots=3, max_t=32, max_prompt=16, prompt_align=4)
    prompts = [np.array([7, 7, 7]), np.arange(13) % VOCAB]
    outs = {}
    for paged in (False, True):
        with engine(lm_bundle, max_new_tokens=7, paged=paged,
                    page_tokens=4, **geometry) as eng:
            outs[paged] = [list(eng.generate(p, timeout=120))
                           for p in prompts]
    assert outs[True] == outs[False] == ref_tokens(
        lm_bundle, prompts, 7, paged=False, **geometry)
