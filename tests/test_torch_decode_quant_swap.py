"""Decode with int8 weights and int8 KV pages, hot swap, and the decode
programs as CUDA graphs, in the port, on the CPU.

- The decode tests of the reference's ``tests/test_quant.py`` (int8
  weights and int8 pages token-identical to f32, the scale pools sharing
  the page semantics, the f32↔int8 swap rules), ``tests/test_swap.py``
  (a swap drains the old weights' generations; the drain bound finishes
  stragglers) and ``tests/test_retrace_guard.py`` (no new program across
  3 swaps; the paged, prefix-sharing, speculative loop warmed) through
  the port's engine on bundles the reference trained and quantized.
- With a stand-in for the CUDA graph API (a capture runs the body, a
  replay runs it again), each program is captured once at ``start()``,
  the captures equal ``programs_live`` and stay flat through a ragged mix
  and 3 swaps with tokens equal to the oracle's, a failed capture raises
  naming the program, and a cache array or a weight rebound to a new
  tensor is refused by the next replay.
- A cache update that rebinds its pool instead of writing it in place
  raises; a swap that leaves the prefix cache stale gives other tokens
  than a fresh engine on the new weights, which the engine's own swap
  does not; the spill tier (ROADMAP A12b) is refused.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from test_torch_decode import (VOCAB, attn_oracle_logits, engine,
                               oracle_greedy, params_of)
from znicz_tpu.serving import quantize as ref_quantize
from znicz_tpu_torch.export import SwapIncompatible, read_bundle
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.ops.attention import MultiHeadAttention
from znicz_tpu_torch.serving import DecodeEngine, DecodeModel
from znicz_tpu_torch.serving.batcher import DeadlineExceeded
from znicz_tpu_torch.serving.decode import DecodeEngine as _Engine
from znicz_tpu_torch.utils.config import reset_root, root

SITES = ("serving-prefill", "serving-decode", "serving-verify",
         "serving-page")


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Two tiny LMs trained by the reference (1 and 3 epochs), the int8
    twin of the second by the reference's quantizer, and a small
    drafter."""
    from benchmarks.serve_bench import train_and_export_lm
    d = tmp_path_factory.mktemp("quant_swap")
    a = train_and_export_lm(str(d / "lm_a.npz"), vocab=VOCAB, epochs=1)
    b = train_and_export_lm(str(d / "lm_b.npz"), vocab=VOCAB, epochs=3)
    manifest, params = read_bundle(b)
    qman, qparams, _info = ref_quantize.quantize_bundle(manifest, params)
    q = str(d / "lm_b_int8.npz")
    arrays = {k: np.asarray(v) for k, v in qparams.items()}
    arrays["manifest"] = np.frombuffer(json.dumps(qman).encode(), np.uint8)
    np.savez_compressed(q, **arrays)
    small = train_and_export_lm(str(d / "draft.npz"), vocab=VOCAB, dim=8,
                                n_heads=1, epochs=1, seed=5)
    return {"a": a, "b": b, "q": q, "draft": small}


def _greedy(bundle_or_model, prompts, n=6, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_t", 32)
    kw.setdefault("max_prompt", 8)
    kw.setdefault("prompt_align", 4)
    with DecodeEngine(bundle_or_model, max_new_tokens=n, device="cpu",
                      **kw) as eng:
        outs = [np.asarray(eng.submit(p).result(timeout=300))
                for p in prompts]
        st = eng.stats()
    return outs, st


def _dequantized_oracle(qbundle):
    """The int8 bundle's weights dequantized on the host (``q·scale`` in
    f32, the programs' arithmetic), for the numpy oracle."""
    man, params = read_bundle(qbundle)
    return man, ref_quantize.dequantize_params(man, params)


# ----------------------------------------------------------------------
# int8 weights and int8 KV pages (tests/test_quant.py)
# ----------------------------------------------------------------------
def test_decode_int8_weights_token_identical(bundles):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(2, 8, size=4)]
    want, _st = _greedy(bundles["b"], prompts, paged=False)
    got, st = _greedy(bundles["q"], prompts, paged=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert st["quant"]["weights"] == "int8"
    man, dq = _dequantized_oracle(bundles["q"])
    for p, g in zip(prompts, got):
        assert list(g) == oracle_greedy(attn_oracle_logits, man, dq, p, 6)


def test_decode_kv_quant_token_identical_and_halved(bundles):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in rng.integers(2, 8, size=4)]
    kw = dict(paged=True, page_tokens=8, pool_tokens=64)
    want, st_f = _greedy(bundles["b"], prompts, **kw)
    got, st_q = _greedy(bundles["b"], prompts, kv_quant=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert st_q["quant"]["kv_pages"] == "int8"
    assert st_q["kv_bytes_per_lane"] < st_f["kv_bytes_per_lane"]


def test_kv_quant_scale_pools_share_page_semantics(bundles):
    model = DecodeModel(bundles["b"], max_slots=2, max_t=32, max_prompt=8,
                        prompt_align=4, paged=True, page_tokens=8,
                        pool_tokens=64, kv_quant=True, device="cpu")
    cache = model.cache
    kinds = {spec[0]: spec[1] for spec in cache.specs}
    scales = [name for name in kinds if name.endswith("_scale")]
    assert scales, cache.specs
    for name in scales:
        assert kinds[name] == "page"
    page_idx = [i for i, spec in enumerate(cache.specs) if spec[1] == "page"]
    assert list(cache.pool_indices) == page_idx
    for i, spec in enumerate(cache.specs):
        if spec[1] != "page":
            continue
        want = torch.float32 if spec[0].endswith("_scale") else torch.int8
        assert cache.arrays[i].dtype == want, spec


def test_decode_swap_compat_matrix(bundles):
    man_f, par_f = read_bundle(bundles["b"])
    man_q, par_q = read_bundle(bundles["q"])
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, VOCAB, size=6).astype(np.int32)
    kw = dict(max_slots=2, max_t=32, max_prompt=8, prompt_align=4,
              paged=True, page_tokens=8, pool_tokens=64, device="cpu")
    m_q = DecodeModel(bundles["q"], **kw)
    with pytest.raises(SwapIncompatible):
        m_q.swap_weights(par_f, manifest=man_f)
    m_q.swap_weights(par_q, manifest=man_q)
    m_f = DecodeModel(bundles["b"], **kw)
    with DecodeEngine(m_f, max_new_tokens=5) as eng:
        eng.submit(prompt).result(timeout=300)
        warmed = m_f.compile_count
        eng.swap_weights((man_q, par_q))
        got = np.asarray(eng.submit(prompt).result(timeout=300))
        assert m_f.compile_count == warmed
    kw.pop("device")
    want, _st = _greedy(bundles["q"], [prompt], n=5, **kw)
    np.testing.assert_array_equal(got, want[0])


# ----------------------------------------------------------------------
# drains (tests/test_swap.py)
# ----------------------------------------------------------------------
def test_decode_swap_drains_old_model_generations(bundles):
    a, b = bundles["a"], bundles["b"]
    kw = dict(max_slots=4, max_t=64, max_prompt=16, prompt_align=8,
              max_new_tokens=16)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 12, size=n).astype(np.int32) for n in (3, 7)]
    with engine(a, **kw) as ora:
        want_a = [np.asarray(ora.generate(p, timeout=120)) for p in prompts]
    with engine(b, **kw) as orb:
        want_b = [np.asarray(orb.generate(p, timeout=120)) for p in prompts]
    eng = engine(a, **kw)
    eng.start()
    try:
        futs = [eng.submit(p) for p in prompts]
        deadline = time.monotonic() + 10
        while eng._pending and time.monotonic() < deadline:
            time.sleep(0.001)
        res = eng.swap_weights(b, drain_ms=30_000)
        for fut, want in zip(futs, want_a):
            np.testing.assert_array_equal(
                np.asarray(fut.result(timeout=120)), want,
                err_msg="an in-flight generation mixed in new logits")
        assert res["evicted"] == 0 and res["version"] == 1
        for p, want in zip(prompts, want_b):
            np.testing.assert_array_equal(
                np.asarray(eng.generate(p, timeout=120)), want)
    finally:
        eng.shutdown()


def test_decode_swap_drain_bound_evicts_stragglers(bundles):
    a, b = bundles["a"], bundles["b"]
    eng = engine(a, max_slots=2, max_t=4096, max_prompt=16, prompt_align=8,
                 max_new_tokens=10_000)
    eng.start()
    try:
        rng = np.random.default_rng(12)
        futs = [eng.submit(rng.integers(0, 12, size=5)) for _ in range(2)]
        deadline = time.monotonic() + 10
        while (eng._pending or not eng._live) \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        res = eng.swap_weights(b, drain_ms=30, timeout=120)
        assert res["evicted"] >= 1, res
        for fut in futs:
            toks = np.asarray(fut.result(timeout=60))
            assert toks.ndim == 1 and len(toks) >= 1
        out = eng.generate(np.arange(4) % 12, max_new_tokens=8, timeout=120)
        assert len(out) >= 1
        assert eng.model_version == 1
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# no new program (tests/test_retrace_guard.py)
# ----------------------------------------------------------------------
def test_warmed_decode_loop_no_new_program_across_3_swaps(bundles):
    a, b = bundles["a"], bundles["b"]
    eng = engine(a, max_slots=4, max_t=64, max_prompt=16, prompt_align=8,
                 max_new_tokens=8)
    eng.start()
    rng = np.random.default_rng(14)
    try:
        for n in (2, 9, 16):
            eng.generate(rng.integers(0, 12, size=n), timeout=120)
        warmed = eng.model.compile_count
        for swap_to in (b, a, b):
            eng.swap_weights(swap_to, drain_ms=10_000)
            for n in (1, 7, 12):
                assert len(eng.generate(rng.integers(0, 12, size=n),
                                        timeout=120)) >= 1
        assert eng.model.compile_count == warmed
        assert eng.model.programs_live == eng.warmup_compiles
        assert eng.swap_counts["promoted"] == 3
    finally:
        eng.shutdown()


def _wave(eng, rng, shared, n):
    prompts = []
    for ln in rng.integers(1, 5, size=n):
        p = np.concatenate([shared[:rng.integers(0, 13)],
                            rng.integers(0, 12, size=int(ln))])
        prompts.append(p[:16].astype(np.int32))
    futs = [eng.submit(p) for p in prompts]
    return prompts, [list(f.result(timeout=240)) for f in futs]


def test_warmed_paged_spec_loop_no_new_program(bundles):
    big, small = bundles["b"], bundles["draft"]
    rng = np.random.default_rng(23)
    shared = rng.integers(0, 12, size=12).astype(np.int32)
    eng = engine(big, max_slots=4, max_t=64, max_prompt=16, prompt_align=8,
                 max_new_tokens=9, page_tokens=8, spec_draft_k=2,
                 drafter=small)
    eng.start()
    try:
        _wave(eng, rng, shared, 6)
        warmed = eng.model.compile_count + eng.drafter.compile_count
        assert eng.warmup_compiles == sum(
            m.programs_live for m in (eng.model, eng.drafter))
        _wave(eng, rng, shared, 9)
        eng.swap_weights(big, drain_ms=10_000)
        _wave(eng, rng, shared, 6)
        assert eng.model.compile_count + eng.drafter.compile_count == warmed
    finally:
        eng.shutdown()


# ----------------------------------------------------------------------
# the programs as CUDA graphs, with a stand-in for the graph API
# ----------------------------------------------------------------------
class _Graph:
    """A stand-in ``CUDAGraph``: a capture runs the body once, a replay
    runs what was bound to it."""

    def __init__(self):
        self.run = None
        self.replays = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1
        self.run()


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """The CUDA graph API stood in for on the CPU and ``DecodeModel``
    graphed there: a capture runs the body once (over the warm-up's
    inputs), a replay runs it again into the captured output."""
    capture = DecodeModel._capture

    def bound_capture(self, prog, family):
        capture(self, prog, family)

        def rerun():
            with torch.no_grad():
                out = prog.body()
            if out is not None:
                prog.out.copy_(out)

        prog.graph.run = rerun

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(DecodeModel, "graphed", property(lambda self: True))
    monkeypatch.setattr(DecodeModel, "_capture", bound_capture)


def _captures() -> float:
    return sum(metrics.graph_captures(site).value for site in SITES)


def test_graphed_programs_captured_once_and_flat_across_swaps(
        bundles, fake_graphs):
    a, b = bundles["a"], bundles["b"]
    rng = np.random.default_rng(31)
    shared = rng.integers(0, 12, size=12).astype(np.int32)
    before = _captures()
    eng = engine(b, max_slots=4, max_t=64, max_prompt=16, prompt_align=8,
                 max_new_tokens=9, page_tokens=8, spec_draft_k=2,
                 drafter=bundles["draft"])
    eng.start()
    try:
        live = eng.model.programs_live + eng.drafter.programs_live
        assert eng.stats()["captures"] == live == eng.warmup_compiles
        assert _captures() - before == live
        prompts, got = _wave(eng, rng, shared, 8)
        man, P = params_of(b)
        for p, g in zip(prompts, got):
            assert g == oracle_greedy(attn_oracle_logits, man, P, p, 9)
        for swap_to in (a, b, a):
            eng.swap_weights(swap_to, drain_ms=10_000)
            _wave(eng, rng, shared, 5)
        assert eng.stats()["captures"] == live
        assert _captures() - before == live
        replays = sum(p.graph.replays for fam in eng.model._programs.values()
                      for p in fam.values())
        assert replays > 0
        # the last swap put a back: a's tokens, from its weights in place
        man, P = params_of(a)
        prompts, got = _wave(eng, rng, shared, 4)
        for p, g in zip(prompts, got):
            assert g == oracle_greedy(attn_oracle_logits, man, P, p, 9)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("what", ["cache", "weight"])
def test_rebound_tensor_refused_by_the_next_replay(bundles, fake_graphs,
                                                   what):
    model = DecodeModel(bundles["b"], max_slots=2, max_t=32, max_prompt=8,
                        prompt_align=4, device="cpu")
    model.warmup()
    assert model.captures == model.programs_live
    model.run_prefill(np.array([1, 2, 3]), 0)
    if what == "cache":
        model.cache.arrays[0] = model.cache.arrays[0].clone()
        match = "cache array 'l2.k' was rebound"
    else:
        ws = list(model._weights)
        ws[2] = (ws[2][0].clone(),) + ws[2][1:]
        model._weights = tuple(ws)
        match = "weight layer2_weights was rebound"
    with pytest.raises(RuntimeError, match=match):
        model.run_decode(np.array([4]), np.array([0]), np.array([3]))


def test_failed_capture_raises_naming_the_program(bundles, fake_graphs,
                                                  monkeypatch):
    def broken(self, pool=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(_Graph, "capture_begin", broken)
    model = DecodeModel(bundles["b"], max_slots=2, max_t=32, max_prompt=8,
                        prompt_align=4, paged=False, device="cpu")
    with pytest.raises(RuntimeError,
                       match=r"capture of the prefill program 4 failed"):
        model.warmup()


def test_cache_update_that_rebinds_is_caught(bundles, monkeypatch):
    """A paged write that returns a new pool (a functional update)
    instead of writing the cache in place raises at its first run."""
    def rebinding(pool, rows, tables, positions, live):
        block = torch.div(positions.long(), pool.shape[1],
                          rounding_mode="floor").clamp(
                              max=tables.shape[1] - 1)
        page = torch.gather(tables.long(), 1, block)
        return pool.index_put((page, positions.long() % pool.shape[1]),
                              rows.to(pool.dtype))

    monkeypatch.setattr(MultiHeadAttention, "_paged_write",
                        staticmethod(rebinding))
    model = DecodeModel(bundles["b"], max_slots=2, max_t=32, max_prompt=8,
                        prompt_align=4, device="cpu")
    with pytest.raises(RuntimeError, match="rebound by its update"):
        model.run_prefill(np.array([1, 2, 3]), 0)


@pytest.mark.parametrize("planted", [False, True])
def test_swap_must_clear_the_prefix_cache(bundles, monkeypatch, planted):
    """After a swap, a prompt whose prefix was cached under the old
    weights gives the new weights' tokens (a fresh engine's); a swap
    that leaves the trie in place gives others."""
    a, b = bundles["a"], bundles["b"]
    if planted:
        monkeypatch.setattr(_Engine, "_clear_prefix", lambda self: None)
    kw = dict(max_slots=2, max_t=64, max_prompt=32, prompt_align=4,
              max_new_tokens=8, page_tokens=4)
    rng = np.random.default_rng(41)
    shared = rng.integers(0, 12, size=24).astype(np.int32)
    prompt = np.concatenate([shared, [3, 5]]).astype(np.int32)
    with engine(b, **kw) as fresh:
        want = list(fresh.generate(prompt, timeout=120))
    with engine(a, **kw) as eng:
        eng.generate(shared, timeout=120)  # caches a's K/V of `shared`
        eng.swap_weights(b, drain_ms=10_000)
        got = list(eng.generate(prompt, timeout=120))
        hits = eng.stats()["prefix_cache"]["hits"]
    if planted:
        assert hits == 1 and got != want
    else:
        assert hits == 0 and got == want


def test_decode_fault_sites_in_the_dispatch(bundles):
    """``serving.program_error`` fails a decode dispatch, which the retry
    budget runs again (the CPU's caches are untouched by a failure
    raised before the program); ``serving.latency_spike`` holds the
    scheduler, and a TTFT-deadlined prompt queued behind it expires.
    Tokens stay the oracle's; each firing is counted."""
    man, P = params_of(bundles["b"])
    root.common.engine.faults = {"serving.program_error": {"at": [3]},
                                 "serving.latency_spike": {"at": [1],
                                                           "ms": 300}}
    fired = {site: metrics.faults_injected(site).value
             for site in ("serving.program_error", "serving.latency_spike")}
    prompt = np.array([1, 2, 3])
    with engine(bundles["b"], max_slots=1, max_t=32, max_prompt=8,
                prompt_align=4, max_new_tokens=6, retry_budget=1) as eng:
        first = eng.submit(prompt)  # its prefill rides the spike
        doomed = eng.submit(np.array([4]), deadline_ms=60)
        assert list(first.result(timeout=120)) == oracle_greedy(
            attn_oracle_logits, man, P, prompt, 6)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=60)
        st = eng.stats()
    assert st["resilience"]["retried"] == 1
    assert st["resilience"]["expired"] == 1
    for site, before in fired.items():
        assert metrics.faults_injected(site).value == before + 1, site


def test_spill_tier_is_refused_naming_its_owner(bundles):
    """``spill_pages`` and ``engine.kv_spill_pages`` build a host-DRAM tier
    of that many frames behind the prefix cache."""
    eng = engine(bundles["b"], max_slots=2, max_t=32, max_prompt=8,
                 spill_pages=4)
    assert eng._spill.capacity == 4 and eng._spill.used == 0
    assert eng.stats()["prefix_cache"]["spill_capacity"] == 4
    eng._spill.shutdown()
    root.common.engine.kv_spill_pages = 2
    eng = engine(bundles["b"], max_slots=2, max_t=32, max_prompt=8)
    assert eng._spill.capacity == 2
    assert [f.shape for f in eng._spill._frames] == [
        (2,) + shape for shape, _dtype in eng.model.page_shapes()]
    eng._spill.shutdown()
