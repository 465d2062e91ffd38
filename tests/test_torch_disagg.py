"""Disaggregated decode in the port (``znicz_tpu_torch.serving.disagg``)
on the CPU: the bars of the reference's ``tests/test_disagg.py`` through
the port's ``DisaggEngine(device="cpu")``, held to the reference's
engines on the same bundles.

The bundle is the reference's own ``train_and_export_lm`` LM
(``vocab=12``), read unchanged by both packages; the ground truth is the
step-by-step numpy oracle of ``tests/test_torch_decode.py``.  The bars:

- token identity: disaggregated = fused = oracle = the reference's
  engines, on token ids, across handoffs, spills, restores and retried
  handoffs;
- exactly-once accounting: every page's refcount equals its holders,
  every trie block lives in exactly one tier, and every token-budget
  reservation is released once, under handoff drops too;
- capture-free scale: the pools' caches are partitions the model
  planned, so a scale-up or a repair makes no program (and, with a
  stand-in for the CUDA graph API, captures no graph).

Beside them: the host tier and the staging ring alone, the LSTM chain's
carry handoff against the reference's engine, and int8 pages handed off.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from test_torch_decode import (VOCAB, attn_oracle_logits, lstm_oracle_logits,
                               oracle_greedy, params_of, train_rnn_bundle)
from test_torch_decode_quant_swap import fake_graphs  # noqa: F401
from znicz_tpu.resilience.faults import FaultInjected as RefFaultInjected
from znicz_tpu.serving import DecodeEngine as RefDecodeEngine
from znicz_tpu.serving import DisaggEngine as RefDisaggEngine
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.memory import HostPageTier, PageStager
from znicz_tpu_torch.observe import metrics
from znicz_tpu_torch.resilience.faults import FaultInjected
from znicz_tpu_torch.serving import (DecodeEngine, DecodeModel, DisaggEngine,
                                     PoolAutoscaler)
from znicz_tpu_torch.utils.config import reset_root, root

#: the reference test's geometry
GEOMETRY = dict(max_slots=2, max_t=32, max_prompt=16, prompt_align=4,
                page_tokens=8)
SITES = ("serving-prefill", "serving-decode", "serving-verify",
         "serving-page")


@pytest.fixture(autouse=True)
def port_config():
    reset_root()
    yield
    reset_root()
    ref_root.common.engine.faults = None


@pytest.fixture(scope="module")
def lm_bundle(tmp_path_factory):
    from benchmarks.serve_bench import train_and_export_lm
    path = str(tmp_path_factory.mktemp("disagg") / "lm.npz")
    return train_and_export_lm(path, vocab=VOCAB, epochs=3)


def chaos(recipe) -> None:
    """The same fault recipe in both packages."""
    root.common.engine.faults = dict(recipe)
    ref_root.common.engine.faults = dict(recipe)


def disagg(bundle, **kwargs) -> DisaggEngine:
    return DisaggEngine(bundle, device="cpu", **{**GEOMETRY, **kwargs})


def oracle(bundle, prompt, n):
    man, P = params_of(bundle)
    return oracle_greedy(attn_oracle_logits, man, P, prompt, n)


def assert_tiered_accounting(cache, prefix, tier):
    """Every pool page's refcount equals its holders (slot tables and the
    trie's page-resident pins), every trie block lives in exactly one
    tier, the free list holds no referenced page, and the host tier's
    occupancy equals the spilled blocks (the reference test's
    invariant)."""
    free = cache._free_pages
    assert len(set(free)) == len(free), "double-freed page"
    refs = np.zeros(cache.pool_pages, np.int64)
    for slot in range(cache.max_slots):
        for pid in cache.tables[slot]:
            if int(pid) != cache.trash_page:
                refs[int(pid)] += 1
    hosted = 0
    stack = list(prefix.root.children.values()) if prefix else []
    while stack:
        node = stack.pop()
        assert (node.page is None) != (node.host is None), \
            "trie block in zero or two tiers"
        if node.page is not None:
            refs[node.page] += 1
        else:
            hosted += 1
        stack.extend(node.children.values())
    assert np.array_equal(refs, cache.ref), (refs, cache.ref)
    assert all(int(cache.ref[p]) == 0 for p in free)
    assert hosted == (tier.used if tier is not None else 0)


def assert_drained(eng):
    """Both pools idle: slots and non-trie pages back, reservations
    balanced."""
    assert eng.balanced(), "token budget unbalanced"
    for w in eng.prefill_pool.engines():
        assert w.cache.free_slots == w.cache.max_slots
        assert_tiered_accounting(w.cache, w.prefix, w._spill)
    for w in eng.decode_pool.engines():
        assert w.cache.free_slots == w.cache.max_slots
        assert w.cache.pages_used() == 0, "decode pages leaked"


def ragged(seed, n, lo=2, hi=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def ids(results) -> list:
    return [[int(t) for t in r] for r in results]


# ----------------------------------------------------------------------
# the core contract: the oracle's tokens through the handoff
# ----------------------------------------------------------------------
def test_disagg_serves_oracle_exact_with_handoffs(lm_bundle):
    """Concurrent ragged prompts through prefill pool → handoff → decode
    pool: the oracle's tokens, the reference's disaggregated and fused
    engines' tokens, every prompt handed off once, both pools drained."""
    prompts = ragged(23, 5)
    with disagg(lm_bundle, max_new_tokens=6) as eng:
        futs = [eng.submit(p) for p in prompts]
        got = ids(f.result(timeout=240) for f in futs)
        st = eng.stats()
        assert_drained(eng)
        fam = metrics.REGISTRY.get("znicz_serving_queue_age_seconds")
        pools = {k[1] for k, _c in fam.items() if k[0] == eng._obs_id}
        assert pools == {"prefill", "decode"}, pools
    with RefDisaggEngine(lm_bundle, max_new_tokens=6, **GEOMETRY) as ref:
        want = ids(ref.generate(p, timeout=240) for p in prompts)
        ref_st = ref.stats()
    with RefDecodeEngine(lm_bundle, max_new_tokens=6, **GEOMETRY) as ref:
        fused = ids(ref.generate(p, timeout=240) for p in prompts)
    assert got == want == fused
    for p, g in zip(prompts, got):
        assert g == oracle(lm_bundle, p, 6)
    assert st["engine"] == "decode-disagg"
    assert st["handoffs"] == ref_st["handoffs"]
    assert st["handoffs"]["total"] == len(prompts)
    assert st["served"] == len(prompts) and st["rejected"] == 0


def test_disagg_equals_fused_and_scale_up_makes_no_program(lm_bundle):
    """The port's fused engine and its disaggregated one give the same
    tokens over a ragged mix; the decode pool then grows mid-flight
    within the planned caches, makes no program, and still matches."""
    prompts = ragged(31, 10, lo=1, hi=14)
    with DecodeEngine(lm_bundle, max_new_tokens=8, device="cpu",
                      **GEOMETRY) as eng:
        fused = ids(eng.generate(p, timeout=240) for p in prompts)
    with disagg(lm_bundle, max_new_tokens=8, decode_replicas=2) as eng:
        got = ids(f.result(timeout=240)
                  for f in [eng.submit(p) for p in prompts])
        assert got == fused, "disaggregation changed tokens"
        model = eng.model
        live = model.programs_live
        made = model.compile_count
        assert model.caches_free == model.n_caches - 3
        eng.decode_pool.scale_to(4, "test")
        eng.prefill_pool.scale_to(3, "test")
        assert model.caches_free == model.n_caches - 7
        regen = ids(f.result(timeout=240)
                    for f in [eng.submit(p) for p in prompts])
        assert regen == fused, "scale-up changed tokens"
        assert (model.programs_live, model.compile_count) == (live, made), \
            "pool scale-up made a program"
        st = eng.stats()
        assert st["pools"]["decode"]["live"] == 4
        assert st["caches"] == {"planned": 8, "free": 1}
        assert_drained(eng)
        # a shrink gives its caches back
        eng.decode_pool.scale_to(1, "test")
        assert model.caches_free == model.n_caches - 4
    assert model.caches_free == model.n_caches


def test_make_cache_is_bounded_by_the_plan(lm_bundle):
    model = DecodeModel(lm_bundle, device="cpu", n_caches=2, **GEOMETRY)
    a, b = model.make_cache(), model.make_cache()
    assert (a.index, b.index) == (1, 2)
    assert a.arrays is b.arrays is model.cache.arrays
    assert (a.pool_pages, a.max_slots) == (model.cache.pool_pages,
                                           model.max_slots)
    with pytest.raises(RuntimeError, match="n_caches=2"):
        model.make_cache()
    model.release_cache(a)
    with pytest.raises(ValueError, match="not handed out"):
        model.release_cache(a)
    assert model.make_cache().index == 1
    with pytest.raises(ValueError, match="DecodeModel\\(n_caches=8\\)"):
        DisaggEngine(model)
    with pytest.raises(ValueError, match="paged cache"):
        DecodeModel(lm_bundle, device="cpu", paged=False, n_caches=1,
                    **GEOMETRY)


def _captures() -> float:
    return sum(metrics.graph_captures(site).value for site in SITES)


def test_scale_up_and_repair_capture_nothing(lm_bundle, fake_graphs):
    """With a stand-in for the CUDA graph API: ``start()`` captures each
    program once (``page_in`` among them); growing the decode pool from 2
    to 4 and repairing a killed worker capture nothing, and the replayed
    programs still give the oracle's tokens."""
    prompts = ragged(5, 6)
    before = _captures()
    with disagg(lm_bundle, max_new_tokens=5, decode_replicas=2) as eng:
        model = eng.model
        assert model.captures == model.programs_live == eng.warmup_compiles
        assert "page-in" in model._programs["page-in"]
        assert _captures() - before == model.captures
        got = ids(f.result(timeout=240)
                  for f in [eng.submit(p) for p in prompts])
        eng.decode_pool.scale_to(4, "test")
        assert eng.decode_pool.kill_one()
        eng.decode_pool.scale_to(eng.decode_pool.target, reason="repair")
        assert eng.decode_pool.live() == 4
        regen = ids(f.result(timeout=240)
                    for f in [eng.submit(p) for p in prompts])
        assert _captures() - before == model.captures \
            == model.programs_live
        replays = sum(p.graph.replays for fam in model._programs.values()
                      for p in fam.values())
        assert replays > 0
        assert model._programs["page-in"]["page-in"].graph.replays > 0
        assert_drained(eng)
    assert got == regen == [oracle(lm_bundle, p, 5) for p in prompts]


def test_dispatch_logits_are_the_callers_own(lm_bundle, fake_graphs):
    """C19: a replay's output is the program's buffer, so the logits a
    dispatch returns must be a copy: with the stand-in for the CUDA graph
    API, a second dispatch of the same program (another worker's, once
    the dispatch lock is released) leaves the first caller's logits as
    they were."""
    model = DecodeModel(lm_bundle, device="cpu", n_caches=1, **GEOMETRY)
    model.warmup()
    first = model.run_prefill(np.array([1, 2, 3], np.int32), 0)
    kept = first.copy()
    second = model.run_prefill(np.array([5, 4, 7], np.int32), 1)
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)
    steps = [model.run_decode(np.array([t, 2], np.int32),
                              np.array([0, 1], np.int32),
                              np.array([3, 3], np.int32))
             for t in (1, 9)]
    assert not np.array_equal(steps[0], steps[1])


def test_rebound_staging_tensor_refused_by_the_next_replay(lm_bundle,
                                                           fake_graphs):
    model = DecodeModel(lm_bundle, device="cpu", n_caches=1, **GEOMETRY)
    model.warmup(page_io=True)
    cache = model.make_cache()
    page = [np.ones(s, d) for s, d in model.page_shapes()]
    model.page_in(page, 3, cache=cache)
    assert np.array_equal(model.export_page(3, cache=cache)[0], page[0])
    model.page_stage[0] = model.page_stage[0].clone()
    with pytest.raises(RuntimeError,
                       match="page staging tensor 0 was rebound"):
        model.page_in(page, 3, cache=cache)


# ----------------------------------------------------------------------
# dropped handoffs: a retry on a fresh prefill, the budget exactly once
# ----------------------------------------------------------------------
def test_handoff_drop_retried_on_fresh_prefill(lm_bundle):
    """A dropped handoff requeues the request at the front with its
    reservation kept; the fresh prefill (a prefix hit) hands off again,
    the tokens unchanged — as in the reference's engine."""
    chaos({"disagg.handoff_drop": {"at": [1]}})
    prompt = np.arange(10, dtype=np.int32) % VOCAB
    fired = metrics.faults_injected("disagg.handoff_drop").value
    with disagg(lm_bundle, max_new_tokens=5) as eng:
        got = [int(t) for t in eng.generate(prompt, timeout=240)]
        st = eng.stats()
        assert_drained(eng)
    with RefDisaggEngine(lm_bundle, max_new_tokens=5, **GEOMETRY) as ref:
        want = [int(t) for t in ref.generate(prompt, timeout=240)]
        ref_st = ref.stats()
    assert got == want == oracle(lm_bundle, prompt, 5)
    assert st["handoffs"] == ref_st["handoffs"]
    assert st["handoffs"]["dropped"] == st["handoffs"]["retried"] == 1
    assert st["served"] == 1 and st["rejected"] == 0
    assert st["prefix_cache"]["hits"] == ref_st["prefix_cache"]["hits"] >= 1
    assert metrics.faults_injected("disagg.handoff_drop").value == fired + 1


def test_handoff_drop_past_budget_rejects_balanced(lm_bundle):
    """Every retry dropped too: the request fails with FaultInjected in
    both packages, the reservation released once, no page leaked."""
    chaos({"disagg.handoff_drop": {"after": 1}})
    prompt = np.arange(6, dtype=np.int32) % VOCAB
    with disagg(lm_bundle, max_new_tokens=5, handoff_retry_budget=1) as eng:
        with pytest.raises(FaultInjected, match="retry budget"):
            eng.submit(prompt).result(timeout=240)
        st = eng.stats()
        assert_drained(eng)
    with RefDisaggEngine(lm_bundle, max_new_tokens=5, handoff_retry_budget=1,
                         **GEOMETRY) as ref:
        with pytest.raises(RefFaultInjected, match="retry budget"):
            ref.submit(prompt).result(timeout=240)
        ref_st = ref.stats()
    assert st["handoffs"] == ref_st["handoffs"]
    assert st["handoffs"]["dropped"] == 2 and st["handoffs"]["retried"] == 1
    assert st["rejected"] == 1 and st["served"] == 0
    assert st["token_budget"]["used"] == 0


# ----------------------------------------------------------------------
# the host tier behind the trie: spill → restore, exactly once
# ----------------------------------------------------------------------
def test_spill_restore_exactly_once_token_identical(lm_bundle):
    """A prefix working set far past the page pool: cold trie pages spill
    to the host tier and restore on a re-match.  Same hits and tokens as
    the all-device pool, restores exercised, the tiered accounting exact
    after every request, the same spill and restore counts as the
    reference's engine, and a clear empties both tiers."""
    rng = np.random.default_rng(41)
    families = [rng.integers(0, VOCAB, size=16).astype(np.int32)
                for _ in range(12)]
    prompts = [np.concatenate([f, rng.integers(0, VOCAB, size=4)
                               .astype(np.int32)])
               for _ in range(2) for f in families]
    geometry = dict(GEOMETRY, max_prompt=24, max_new_tokens=4)
    with DecodeEngine(lm_bundle, pool_tokens=2048, device="cpu",
                      **geometry) as eng:
        base = ids(eng.generate(p, timeout=240) for p in prompts)
        hbm = eng.stats()["prefix_cache"]
    with DecodeEngine(lm_bundle, pool_tokens=160, spill_pages=64,
                      device="cpu", **geometry) as eng:
        got = []
        for p in prompts:
            got.append([int(t) for t in eng.generate(p, timeout=240)])
            assert_tiered_accounting(eng.model.cache, eng.prefix, eng._spill)
        st = eng.stats()["prefix_cache"]
        assert st["migrations"]["spill"] > 0 and \
            st["migrations"]["restore"] > 0, st
        assert st["spill_pages_used"] == st["spilled_nodes"]
        assert eng.model.cache.pool_pages < 2 * len(families)
        assert st["hits"] == hbm["hits"], (st, hbm)
        assert metrics.kv_spill_pages(eng._obs_id).value \
            == st["spill_pages_used"]
        eng.prefix.clear(eng.model.cache, tier=eng._spill)
        assert eng.model.cache.pages_used() == 0
        assert eng._spill.used == 0
    with RefDecodeEngine(lm_bundle, pool_tokens=160, spill_pages=64,
                         **geometry) as ref:
        want = ids(ref.generate(p, timeout=240) for p in prompts)
        ref_st = ref.stats()["prefix_cache"]
    assert got == base == want, "the spill tier changed tokens"
    assert st["migrations"] == ref_st["migrations"]
    assert (st["hits"], st["spilled_nodes"]) == (ref_st["hits"],
                                                 ref_st["spilled_nodes"])


def test_spill_pages_build_a_tier_of_that_many_frames(lm_bundle):
    """``spill_pages`` and ``engine.kv_spill_pages`` both build the tier
    (and none without a prefix cache)."""
    eng = DecodeEngine(lm_bundle, spill_pages=4, device="cpu", **GEOMETRY)
    assert eng._spill.capacity == 4 and eng._spill.used == 0
    assert not eng._spill.pinned  # page-locked only for the card
    eng._spill.shutdown()
    root.common.engine.kv_spill_pages = 3
    eng = DecodeEngine(lm_bundle, device="cpu", **GEOMETRY)
    assert eng._spill.capacity == 3
    eng._spill.shutdown()
    assert DecodeEngine(lm_bundle, device="cpu", prefix_cache=False,
                        **GEOMETRY)._spill is None


def test_disagg_spill_cow_eviction_chaos_accounting(lm_bundle):
    """Prefix sharing with copy-on-write forks, pool pressure driving
    spills and eviction, and dropped handoffs mid-stream on one engine:
    the oracle's tokens on every request, every page and reservation
    accounted once at the end."""
    chaos({"disagg.handoff_drop": {"at": [2, 5]}})
    rng = np.random.default_rng(53)
    families = [rng.integers(0, VOCAB, size=16).astype(np.int32)
                for _ in range(6)]
    prompts = []
    for _ in range(2):
        for f in families:
            fork = f.copy()
            fork[12:] = (fork[12:] + 1) % VOCAB  # a copy on write in block 1
            prompts.extend([f, fork])
    with disagg(lm_bundle, max_new_tokens=4, pool_tokens=128, spill_pages=8,
                handoff_retry_budget=2) as eng:
        got = ids(eng.generate(p, timeout=240) for p in prompts)
        st = eng.stats()
        assert_drained(eng)
    for i, (p, g) in enumerate(zip(prompts, got)):
        assert g == oracle(lm_bundle, p, 4), f"prompt {i}"
    assert st["handoffs"]["dropped"] == st["handoffs"]["retried"] == 2
    assert st["served"] == len(prompts) and st["rejected"] == 0
    pc = st["prefix_cache"]
    assert pc["migrations"]["spill"] > 0 and pc["hits"] > 0, pc


# ----------------------------------------------------------------------
# PoolAutoscaler
# ----------------------------------------------------------------------
def test_pool_autoscaler_repairs_dead_decode_replica(lm_bundle):
    """A decode replica dies mid-service: the autoscaler's repair brings
    the pool back on a planned cache, making no program, and traffic
    keeps the oracle's tokens."""
    prompt = np.arange(8, dtype=np.int32) % VOCAB
    want = oracle(lm_bundle, prompt, 5)
    with disagg(lm_bundle, max_new_tokens=5, decode_replicas=2,
                autoscale=True) as eng:
        assert [int(t) for t in eng.generate(prompt, timeout=240)] == want
        made = eng.stats()["programs_compiled"]
        eng.decode_pool.kill_one()
        deadline = time.monotonic() + 20
        while eng.decode_pool.live() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.decode_pool.live() == 2, "no repair"
        assert eng.stats()["programs_compiled"] == made
        assert [int(t) for t in eng.generate(prompt, timeout=240)] == want
        assert_drained(eng)


def test_pool_autoscaler_grows_on_queue_age_and_shrinks_when_idle():
    """Each pool scales on its own queue-age child: an old prefill queue
    grows the prefill pool only, and idle pools shrink to one."""
    class Group:
        def __init__(self, live):
            self.target = self.n = live
            self.max_replicas = 4

        def live(self):
            return self.n

        def engines(self):
            return []

        def scale_to(self, n, reason=""):
            self.n = n
            if reason != "repair":
                self.target = n

    ages = {"prefill": 1.0, "decode": 0.0}
    for pool in ages:
        metrics.serving_queue_age_seconds("eng#t", pool=pool).set_function(
            lambda p=pool: ages[p])
    pools = {"prefill": Group(1), "decode": Group(2)}
    scaler = PoolAutoscaler(pools, "eng#t", idle_down_s=0.0, cooldown_s=0.0)
    events = scaler.tick()
    assert pools["prefill"].n == 2 and pools["decode"].n == 2, events
    ages["prefill"] = 0.0
    scaler.tick()
    time.sleep(0.01)
    scaler.tick()
    assert pools["decode"].n == 1 and pools["prefill"].n == 1
    pools["decode"].n = 0  # a loss: repaired to its target
    assert scaler.tick()[-1].startswith("repaired pool decode")
    assert pools["decode"].n == 1


# ----------------------------------------------------------------------
# the host tier and the staging ring alone
# ----------------------------------------------------------------------
def test_host_tier_frames_handed_out_once():
    shapes = [((4, 2), np.float32), ((4,), np.int8)]
    tier = HostPageTier(shapes, 3)
    try:
        pages = [[np.full((4, 2), i, np.float32), np.full((4,), i, np.int8)]
                 for i in range(4)]
        hids = [tier.store(p) for p in pages]
        assert hids[:3] == [0, 1, 2] and hids[3] is None
        assert tier.full and tier.used == 3
        assert tier.nbytes == 3 * (4 * 2 * 4 + 4)
        for hid, page in zip(hids[:3], pages):
            assert all(np.array_equal(a, b)
                       for a, b in zip(tier.read(hid), page))
        staged = tier.upload(1)
        assert [t.dtype for t in staged] == [torch.float32, torch.int8]
        assert torch.equal(staged[0], torch.full((4, 2), 1.0))
        tier.free(1)
        assert tier.store(pages[3]) == 1 and tier.used == 3
        with pytest.raises(ValueError, match=">= 1 page"):
            HostPageTier(shapes, 0)
    finally:
        tier.shutdown()


def test_page_stager_full_ring_backpressures_then_shuts_down():
    shapes = [((2, 3), np.float32)]
    stager = PageStager(shapes, n_slots=2)
    ring = stager.rings[0]
    held = [ring.acquire(), ring.acquire()]  # every slot downstream
    page = [np.arange(6, dtype=np.float32).reshape(2, 3)]
    with pytest.raises(TimeoutError, match="ring full"):
        stager.upload(page, timeout=0.05)
    for slot in held:
        ring.release(slot)
    out = stager.upload(page)
    assert out is stager.targets
    assert torch.equal(out[0], torch.from_numpy(page[0]))
    assert ring.n_free == 2  # released once its copy landed
    with pytest.raises(ValueError, match="expects 1"):
        stager.upload(page * 2)
    stager.shutdown()
    assert not stager._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        stager.upload(page)


# ----------------------------------------------------------------------
# the LSTM chain's carry handoff, and int8 pages
# ----------------------------------------------------------------------
def test_lstm_chain_hands_off_its_carry_like_the_reference(tmp_path):
    """The reference's engine serves an LSTM chain disaggregated (its
    handoff ships the carry rows, and page sets with no pool in them);
    the port's does too, with the reference's tokens and the oracle's,
    and no prefix trie."""
    path = train_rnn_bundle(str(tmp_path / "rnn.npz"))
    man, P = params_of(path)
    geometry = dict(GEOMETRY, max_prompt=8)
    prompts = [(np.arange(n) * 5 + 2) % VOCAB for n in (1, 4, 7, 8)]
    with disagg(path, max_new_tokens=6, max_prompt=8) as eng:
        assert eng.prefix_cache_enabled is False
        assert eng.model.page_stage == [] and eng.model.carry_stage
        got = ids(eng.generate(p, timeout=240) for p in prompts)
        st = eng.stats()
        assert "carry-in" in eng.model._programs["carry-in"]
        assert_drained(eng)
    with RefDisaggEngine(path, max_new_tokens=6, **geometry) as ref:
        want = ids(ref.generate(p, timeout=240) for p in prompts)
        ref_st = ref.stats()
    assert got == want
    for p, g in zip(prompts, got):
        assert g == oracle_greedy(lstm_oracle_logits, man, P, p, 6)
    assert st["handoffs"] == ref_st["handoffs"]
    assert st["prefix_cache"] is None


def test_int8_pages_hand_off_like_the_fused_engine(lm_bundle):
    """``engine.kv_quant``: a page set carries its int8 K/V rows and their
    f32 scale pools (one staging ring each); the disaggregated tokens
    equal the fused int8 engine's."""
    root.common.engine.kv_quant = True
    prompts = ragged(7, 6)
    with DecodeEngine(lm_bundle, max_new_tokens=6, device="cpu",
                      **GEOMETRY) as eng:
        assert eng.model.kv_quant
        fused = ids(eng.generate(p, timeout=240) for p in prompts)
    with disagg(lm_bundle, max_new_tokens=6) as eng:
        shapes = eng.model.page_shapes()
        assert [np.dtype(d) for _s, d in shapes] == [np.int8, np.int8,
                                                     np.float32, np.float32]
        assert len(eng._stager.rings) == 4
        got = ids(f.result(timeout=240)
                  for f in [eng.submit(p) for p in prompts])
        assert eng.stats()["handoffs"]["pages_moved"] >= len(prompts)
        assert_drained(eng)
    assert got == fused
