"""The paged KV cache, prefix sharing and speculative decoding in the
port, on the CPU: the tests of the reference's
``tests/test_paged_decode.py`` through the port's ``DecodeEngine``.

The bundles are the reference's fixtures (``train_and_export_lm``, the
tiny LSTM LM) and a drafter distilled as ``train_and_export_drafter``
does, by the port's population engine (``train_drafter``); the ground
truth is the
step-by-step numpy oracle of ``tests/test_torch_decode.py``.  The data
plane may only move bytes: the flat cache, the paged cache, prefix
shared admissions, copy on write and the speculative draft/verify loop
all give the oracle's token ids exactly, and on some prompts the
reference's ``DecodeEngine``'s.  ``attach_decode_meta`` writes the same
section in both packages, and each package's engine reads a bundle the
other stamped.
"""

from __future__ import annotations

import shutil
import threading
import time

import numpy as np
import pytest

from test_torch_decode import lm_bundle  # noqa: F401 (the fixture)
from test_torch_decode import (VOCAB, attn_oracle_logits, engine,
                               params_of, ref_tokens, train_rnn_bundle)
from znicz_tpu.export import attach_decode_meta as ref_attach
from znicz_tpu.serving import DecodeEngine as RefEngine
from znicz_tpu_torch.export import attach_decode_meta, read_bundle
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.serving import (Overloaded, PoolExhausted, QueueFull,
                                     TokenBudget)
from znicz_tpu_torch.utils.config import reset_root


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


def _distill_drafter(big_bundle: str, directory: str, n_members: int,
                     epochs: int, n_chains: int, chain_tokens: int,
                     seq_len: int = 8, seed: int = 3) -> str:
    """The reference's ``train_and_export_drafter`` through the port: the
    LM's own greedy chains (the port's engine on the CPU) cut into
    (window → next token) samples, a population of small causal LMs
    (different seeds, evolved rates) trained on them by the port's
    ``train_drafter``, the fittest published."""
    from znicz_tpu_torch.loader.fullbatch import ArrayLoader
    from znicz_tpu_torch.models.standard_workflow import StandardWorkflow
    from znicz_tpu_torch.population import train_drafter

    rng = np.random.default_rng(seed)
    with engine(big_bundle, max_slots=8, max_t=64, max_prompt=seq_len,
                prompt_align=4, max_new_tokens=chain_tokens,
                paged=False) as eng:
        futs = [eng.submit(rng.integers(0, VOCAB, size=int(ln)))
                for ln in rng.integers(1, seq_len + 1, size=n_chains)]
        chains = [np.asarray(f.result(timeout=600)) for f in futs]
    xs, ys = [], []
    for chain in chains:
        for i in range(len(chain) - seq_len):
            xs.append(chain[i:i + seq_len])
            ys.append(chain[i + seq_len])
    data = np.asarray(xs, np.float32)
    labels = np.asarray(ys, np.int32)
    order = rng.permutation(len(data))
    data, labels = data[order], labels[order]
    split = max(32, int(0.85 * len(data)))

    def build(learning_rate=0.08, **kw):
        lr = {"learning_rate": learning_rate, "gradient_moment": 0.9}
        return StandardWorkflow(
            name="drafter",
            loader_factory=lambda w: ArrayLoader(
                w, train_data=data[:split], train_labels=labels[:split],
                valid_data=data[split:], valid_labels=labels[split:],
                minibatch_size=32),
            layers=[
                {"type": "embedding", "->": {"vocab_size": VOCAB, "dim": 8},
                 "<-": lr},
                {"type": "pos_encoding", "->": {}},
                {"type": "attention", "->": {"n_heads": 1, "causal": True},
                 "<-": {**lr, "learning_rate": learning_rate / 2}},
                {"type": "last_token", "->": {}},
                {"type": "softmax", "->": {"output_sample_shape": VOCAB},
                 "<-": lr},
            ],
            decision_config={"max_epochs": epochs})

    _version, path, _trainer = train_drafter(
        build, n_members, publish_dir=directory, device="cpu")
    return path


@pytest.fixture(scope="module")
def drafter_bundle(lm_bundle, tmp_path_factory):
    """A drafter distilled from the LM's own greedy generations by the
    port's population engine (small: two members, two epochs)."""
    directory = str(tmp_path_factory.mktemp("drafter"))
    return _distill_drafter(lm_bundle, directory, n_members=2, epochs=2,
                            n_chains=12, chain_tokens=16)


def oracle(man, P, prompt, n):
    seq = [int(t) for t in prompt]
    out = []
    for _ in range(n):
        tok = int(np.argmax(attn_oracle_logits(man, P, seq)))
        out.append(tok)
        seq.append(tok)
    return out


# ----------------------------------------------------------------------
# paged ≡ flat ≡ oracle
# ----------------------------------------------------------------------
def test_paged_equals_flat_equals_oracle(lm_bundle):
    man, P = params_of(lm_bundle)
    lens = (1, 3, 5, 11, 14)
    outs = {}
    for paged in (False, True):
        with engine(lm_bundle, max_slots=4, max_t=32, max_prompt=16,
                    prompt_align=4, max_new_tokens=8, paged=paged,
                    page_tokens=8) as eng:
            outs[paged] = {n: list(eng.generate((np.arange(n) * 3) % VOCAB,
                                                timeout=240))
                           for n in lens}
        assert eng.stats()["paged"] is paged
    for n in lens:
        want = oracle(man, P, (np.arange(n) * 3) % VOCAB, 8)
        assert outs[True][n] == want, f"paged diverged at len {n}"
        assert outs[False][n] == want, f"flat diverged at len {n}"


def test_paged_lstm_chain(tmp_path):
    """An LSTM in the chain: carries stay slot-indexed, prefix sharing
    turns itself off, tokens equal the flat arm's and the reference's."""
    path = train_rnn_bundle(str(tmp_path / "rnn.npz"), units=16, epochs=1,
                            name="paged_rnn")
    geometry = dict(max_slots=2, max_t=32, max_prompt=8, prompt_align=4,
                    page_tokens=8)
    prompts = [(np.arange(n) * 2 + 1) % VOCAB for n in (1, 4, 7)]
    outs = {}
    for paged in (False, True):
        with engine(path, max_new_tokens=6, paged=paged, **geometry) as eng:
            outs[paged] = [list(eng.generate(p, timeout=240))
                           for p in prompts]
            if paged:
                assert eng.prefix is None
    assert outs[True] == outs[False]
    assert outs[True] == ref_tokens(path, prompts, 6, **geometry)


def test_continuous_admission_paged_matches_oracle(lm_bundle):
    man, P = params_of(lm_bundle)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 13, size=10)]
    budgets = [int(b) for b in rng.integers(3, 12, size=10)]
    with engine(lm_bundle, max_slots=3, max_t=32, max_prompt=16,
                prompt_align=4, page_tokens=8) as eng:
        futs = [eng.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        results = [list(f.result(timeout=240)) for f in futs]
    for i, (p, b, got) in enumerate(zip(prompts, budgets, results)):
        assert got == oracle(man, P, p, b), f"prompt {i}"


# ----------------------------------------------------------------------
# prefix sharing and copy on write
# ----------------------------------------------------------------------
def test_prefix_sharing_matches_unshared_oracle(lm_bundle):
    man, P = params_of(lm_bundle)
    shared = (np.arange(12) * 5 + 2) % VOCAB
    reqs = [np.concatenate([shared, [3, 1]]),
            np.concatenate([shared, [3, 1]]),
            np.concatenate([shared[:10], [9, 9, 4]])]
    with engine(lm_bundle, max_slots=4, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=6, page_tokens=4) as eng:
        got = [list(eng.generate(r, timeout=240)) for r in reqs]
        st = eng.stats()["prefix_cache"]
    for r, g in zip(reqs, got):
        assert g == oracle(man, P, r, 6), "sharing changed tokens"
    assert st["hits"] == 2 and st["misses"] == 1, st
    assert st["shared_tokens"] >= 18, st


def test_cow_divergence_isolation(lm_bundle):
    man, P = params_of(lm_bundle)
    prompt_a = (np.arange(8) * 5 + 1) % VOCAB
    prompt_b = np.concatenate([prompt_a[:6], [7, 7, 2]])
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=8, page_tokens=4) as eng:
        first = list(eng.generate(prompt_a, timeout=240))
        forked = list(eng.generate(prompt_b, timeout=240))
        again = list(eng.generate(prompt_a, timeout=240))
        cache = eng.model.cache
        assert cache.free_slots == 2
        assert cache.pages_used() == eng.prefix.nodes
    assert first == oracle(man, P, prompt_a, 8)
    assert forked == oracle(man, P, prompt_b, 8), \
        "the forked request read someone else's K/V"
    assert again == first, "B's divergence mutated A's shared pages"


def test_trie_eviction_under_pool_pressure(lm_bundle):
    man, P = params_of(lm_bundle)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, size=12).astype(np.int32)
               for _ in range(6)]
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=4, page_tokens=8,
                pool_tokens=32) as eng:
        for p in prompts:
            assert list(eng.generate(p, timeout=240)) == oracle(man, P, p, 4)
        evicted = metrics.prefix_cache_events(eng._obs_id, "evicted").value
    assert evicted > 0


# ----------------------------------------------------------------------
# pool exhaustion
# ----------------------------------------------------------------------
def test_pool_exhaustion_sheds_then_recovers(lm_bundle):
    man, P = params_of(lm_bundle)
    prompts = [np.asarray([i + 1, i + 2], np.int32) for i in range(3)]
    with engine(lm_bundle, max_slots=4, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=16, page_tokens=4,
                pool_tokens=20, prefix_cache=False, max_queue_age_ms=50.0,
                breaker_cooldown_ms=120.0) as eng:
        real_decode = eng.model.run_decode

        def slow_decode(tokens, slots, positions):
            time.sleep(0.01)
            return real_decode(tokens, slots, positions)

        eng.model.run_decode = slow_decode
        futs = [eng.submit(prompts[0]), eng.submit(prompts[1])]
        deadline = time.monotonic() + 20
        while eng.breaker_state != "open" and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.breaker_state == "open", \
            "page-pool exhaustion never tripped the breaker"
        with pytest.raises(Overloaded):
            eng.submit(prompts[2])
        shed = eng.shed_total
        while True:
            try:
                futs.append(eng.submit(prompts[2]))
                break
            except (Overloaded, QueueFull):
                time.sleep(0.02)
        results = [list(f.result(timeout=300)) for f in futs]
        assert eng.page_truncations == 0
    for p, got in zip(prompts, results):
        assert got == oracle(man, P, p, 16)
    assert shed > 0


def test_oversized_request_fails_cleanly(lm_bundle):
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=4, page_tokens=4,
                pool_tokens=16, prefix_cache=False) as eng:
        assert len(eng.generate(np.arange(8) % VOCAB, timeout=240)) == 4
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=16,
                prompt_align=4, max_new_tokens=4, page_tokens=4,
                pool_tokens=8, prefix_cache=False) as eng:
        fut = eng.submit(np.arange(12) % VOCAB)
        with pytest.raises(PoolExhausted):
            fut.result(timeout=240)
        assert eng.model.cache.free_slots == 2
        assert eng.model.cache.free_pages == 2


def _assert_page_accounting(eng):
    """Each page's refcount equals its holders (table references and
    trie pins), and nothing on the free list is referenced."""
    cache = eng.model.cache
    free = cache._free_pages
    assert len(set(free)) == len(free), "double-freed page"
    refs = np.zeros(cache.pool_pages, np.int64)
    for slot in range(cache.max_slots):
        for pid in cache.tables[slot]:
            if int(pid) != cache.trash_page:
                refs[int(pid)] += 1
    stack = list(eng.prefix.root.children.values())
    while stack:
        node = stack.pop()
        refs[node.page] += 1
        stack.extend(node.children.values())
    assert np.array_equal(refs, cache.ref), (refs, cache.ref)
    assert all(int(cache.ref[p]) == 0 for p in free)


def test_matched_pages_survive_own_eviction_pressure(lm_bundle):
    man, P = params_of(lm_bundle)
    rng = np.random.default_rng(11)
    base = rng.integers(0, VOCAB, size=16).astype(np.int32)
    with engine(lm_bundle, max_slots=2, max_t=40, max_prompt=16,
                prompt_align=8, max_new_tokens=4, page_tokens=8,
                pool_tokens=32) as eng:
        assert list(eng.generate(base, timeout=240)) \
            == oracle(man, P, base, 4)
        assert eng.model.cache.free_pages == 2
        assert eng.prefix.nodes == 2
        _assert_page_accounting(eng)
        div = base.copy()
        div[12:] = (div[12:] + 1) % VOCAB
        fut = eng.submit(div, max_new_tokens=24)
        with pytest.raises(PoolExhausted):
            fut.result(timeout=240)
        assert metrics.prefix_cache_events(eng._obs_id,
                                           "evicted").value > 0
        _assert_page_accounting(eng)
        assert list(eng.generate(div, timeout=240)) \
            == oracle(man, P, div, 4)
        _assert_page_accounting(eng)


# ----------------------------------------------------------------------
# speculative decoding
# ----------------------------------------------------------------------
def test_spec_greedy_token_identical(lm_bundle, drafter_bundle):
    """With a drafter distilled by the port's population engine the
    speculative arm emits exactly the greedy tokens (the oracle's, and
    the reference's speculative engine's)."""
    man, P = params_of(lm_bundle)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(1, 14, size=8)]
    geometry = dict(max_slots=3, max_t=32, max_prompt=16, prompt_align=4,
                    spec_draft_k=3, drafter=drafter_bundle, page_tokens=8)
    with engine(lm_bundle, max_new_tokens=12, **geometry) as eng:
        futs = [eng.submit(p) for p in prompts]
        results = [list(f.result(timeout=300)) for f in futs]
        spec = eng.stats()["speculative"]
    for p, got in zip(prompts, results):
        assert got == oracle(man, P, p, 12), "speculation changed tokens"
    assert spec["accepted"] + spec["rejected"] > 0, spec
    assert results[:2] == ref_tokens(lm_bundle, prompts[:2], 12,
                                     **geometry)


def test_spec_self_draft_accepts_everything(lm_bundle):
    with engine(lm_bundle, max_slots=2, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=13, spec_draft_k=3,
                drafter=lm_bundle, page_tokens=8) as eng:
        out = eng.generate(np.array([1, 2, 3]), timeout=300)
        spec = eng.stats()["speculative"]
    assert len(out) == 13
    assert spec["rejected"] == 0 and spec["accepted"] > 0, spec
    assert spec["accept_rate"] == 1.0


def test_spec_sampled_stays_in_vocab_and_reproducible(lm_bundle,
                                                      drafter_bundle):
    prompt = np.array([4, 7, 1])

    def gen(seed):
        with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                    prompt_align=4, max_new_tokens=10, temperature=1.0,
                    seed=seed, spec_draft_k=2, page_tokens=8,
                    drafter=drafter_bundle) as eng:
            return list(eng.generate(prompt, timeout=300))

    a, b = gen(5), gen(5)
    assert a == b
    assert all(0 <= t < VOCAB for t in a)


def test_spec_requires_paged_and_drafter(lm_bundle):
    with pytest.raises(ValueError, match="paged"):
        engine(lm_bundle, max_slots=2, max_t=32, max_prompt=8, paged=False,
               spec_draft_k=2, drafter=lm_bundle)
    with pytest.raises(ValueError, match="drafter"):
        engine(lm_bundle, max_slots=2, max_t=32, max_prompt=8,
               spec_draft_k=2)


# ----------------------------------------------------------------------
# attach_decode_meta, across the packages
# ----------------------------------------------------------------------
def test_attach_decode_meta_round_trip(lm_bundle, tmp_path):
    path = str(tmp_path / "meta_lm.npz")
    shutil.copyfile(lm_bundle, path)
    meta = attach_decode_meta(path, page_tokens=8, drafter=lm_bundle,
                              spec_draft_k=2)
    assert meta == {"kv_page_tokens": 8, "drafter": lm_bundle,
                    "spec_draft_k": 2}
    assert read_bundle(path)[0]["decode"] == meta
    # the reference writes the same section on a copy of the same bundle
    twin = str(tmp_path / "twin.npz")
    shutil.copyfile(lm_bundle, twin)
    assert ref_attach(twin, page_tokens=8, drafter=lm_bundle,
                      spec_draft_k=2) == meta
    assert read_bundle(twin)[0] == read_bundle(path)[0]
    prompt = np.array([2, 5])
    # the port reads the defaults stamped by either package
    for stamped in (path, twin):
        with engine(stamped, max_slots=2, max_t=32, max_prompt=8,
                    prompt_align=4, max_new_tokens=6) as eng:
            assert eng.model.page_tokens == 8
            assert eng.spec_k == 2 and eng.drafter is not None
            got = list(eng.generate(prompt, timeout=300))
    # and the reference's engine reads the port's stamp
    with RefEngine(path, max_slots=2, max_t=32, max_prompt=8,
                   prompt_align=4, max_new_tokens=6) as ref:
        assert ref.model.page_tokens == 8 and ref.spec_k == 2
        assert list(ref.generate(prompt, timeout=300)) == got
    # a published bundle's digest sidecar follows the rewrite
    from znicz_tpu_torch.utils.snapshotter import _sha256_file
    pub = str(tmp_path / "pub_lm.npz")
    shutil.copyfile(lm_bundle, pub)
    with open(f"{pub}.sha256", "w") as f:
        f.write(_sha256_file(pub) + "\n")
    attach_decode_meta(pub, page_tokens=8)
    with open(f"{pub}.sha256") as f:
        assert f.read().strip() == _sha256_file(pub)
    # a scorer bundle refuses decode metadata
    man, params = read_bundle(lm_bundle)
    man = dict(man, kind="scorer")
    fc = str(tmp_path / "scorer.npz")
    np.savez(fc, manifest=np.frombuffer(
        __import__("json").dumps(man).encode(), np.uint8), **params)
    with pytest.raises(ValueError, match="scorer"):
        attach_decode_meta(fc, page_tokens=8)


# ----------------------------------------------------------------------
# token-denominated admission
# ----------------------------------------------------------------------
def test_token_budget_unit():
    b = TokenBudget(100)
    assert b.try_acquire(60) and b.used == 60
    assert not b.try_acquire(50)
    b.release(60)
    assert b.try_acquire(50)
    b2 = TokenBudget(10)
    assert b2.try_acquire(40)
    assert not b2.try_acquire(1)
    b2.release(40)
    with pytest.raises(ValueError):
        TokenBudget(0)


def test_token_budget_bounds_decode_queue(lm_bundle):
    gate = threading.Event()
    with engine(lm_bundle, max_slots=1, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=20, max_queue=64,
                max_queue_tokens=60, prefix_cache=False) as eng:
        real_prefill = eng.model.run_prefill

        def gated_prefill(tokens, slot, start=0):
            gate.wait(timeout=30)
            return real_prefill(tokens, slot, start)

        eng.model.run_prefill = gated_prefill
        first = eng.submit(np.array([1, 2]))
        time.sleep(0.05)
        second = eng.submit(np.array([3]))
        with pytest.raises(QueueFull, match="token budget"):
            eng.submit(np.array([4]))
        gate.set()
        assert len(first.result(timeout=240)) == 20
        assert len(second.result(timeout=240)) == 20
        assert eng._token_budget.used == 0


# ----------------------------------------------------------------------
# admission-eligible TTFT under a swap drain
# ----------------------------------------------------------------------
def test_swap_drain_does_not_pollute_ttft_or_deadlines(lm_bundle):
    man, params = params_of(lm_bundle)
    with engine(lm_bundle, max_slots=1, max_t=128, max_prompt=8,
                prompt_align=4, max_new_tokens=500,
                prefix_cache=False) as eng:
        real_decode = eng.model.run_decode

        def slow_decode(tokens, slots, positions):
            time.sleep(0.01)
            return real_decode(tokens, slots, positions)

        eng.model.run_decode = slow_decode
        runner = eng.submit(np.array([5, 6]))
        time.sleep(0.05)
        swap_done: list = []

        def do_swap():
            swap_done.append(eng.swap_weights((man, params),
                                              drain_ms=400.0))

        t = threading.Thread(target=do_swap, daemon=True)
        t.start()
        time.sleep(0.05)
        queued = eng.submit(np.array([3]), max_new_tokens=8,
                            deadline_ms=250.0)
        out = queued.result(timeout=300)
        t.join(timeout=60)
        runner.result(timeout=60)
        assert len(out) > 0
        assert swap_done and swap_done[0]["evicted"] == 1
        assert eng.expired_total == 0
        pause = metrics.swap_pause_seconds(eng._obs_id).value
        assert pause > 0.2, pause
        assert max(eng._ttft_win) < 0.35, list(eng._ttft_win)
