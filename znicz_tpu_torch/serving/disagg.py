"""Disaggregated decode serving: a prefill pool and a decode pool over
private paged caches, joined by a page-table handoff (port of
``znicz_tpu/serving/disagg.py``).

The fused :class:`~znicz_tpu_torch.serving.decode.DecodeEngine` runs
admission (compute-bound bucketed prefill) and the token loop
(memory-bound paged decode) on one scheduler thread, so a burst of
prompts runs whole admission waves between token steps and every
sequence in flight waits for them.  :class:`DisaggEngine` splits the two
phases into separately scaled replica pools and ships the KV cache from
prefill to decode (the design of DistServe and Splitwise):

- **One warmed** :class:`~znicz_tpu_torch.serving.decode.DecodeModel`
  serves every worker of both pools.  It plans one private cache a
  replica the pools may reach (``max_prefill_replicas +
  max_decode_replicas``) as partitions of one arena, so its programs,
  CUDA graphs on the card, serve every cache: a pool scale-up or a
  repair within the bound captures nothing (``graph_captures`` stays
  flat).  The workers are threads; every dispatch holds the model's
  dispatch lock, as the graphs share one memory pool.
- **Prefill workers** pop prompts from the shared queue, prefill into
  their private cache (with their own prefix trie and host-DRAM spill
  tier), sample the first token (TTFT stamps here), export the prompt's
  K/V pages (and an LSTM chain's carry rows) to page-locked host memory
  and hand off.
- **The handoff** carries host arrays, the format a cross-host handoff
  needs: the pages, the first token and the request with its token
  budget reservation, released exactly once wherever the request ends.
  The pages land in a decode worker's cache through the pinned staging
  ring (:class:`~znicz_tpu_torch.memory.PageStager`) and the captured
  ``page_in`` program.  ``disagg.handoff_drop`` drops a handoff in
  transit: the request retries on a fresh prefill (a prefix hit, so
  cheap), with its pages reclaimed and the budget still balanced.
- **Decode workers** accept handoffs between token steps (bounded by
  their free slots), reserve the whole worst-case span in fresh private
  pages (handed-off content is copied in, never shared across caches),
  and run the continuous token loop as the fused engine's ``_step``.

Per-pool telemetry: ``znicz_serving_queue_age_seconds{pool=prefill}`` is
the shared prompt queue's head age, ``{pool=decode}`` the oldest handoff
not yet accepted; :class:`~znicz_tpu_torch.serving.fleet.PoolAutoscaler`
reads both and scales each pool on its own.  Handoff traffic lands on
``znicz_kv_page_migrations_total{direction=handoff}`` beside the spill
tier's ``spill`` and ``restore``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.serving.batcher import (DeadlineExceeded, Overloaded,
                                             QueueFull, TokenBudget)
from znicz_tpu_torch.serving.decode import (DecodeModel, PoolExhausted,
                                            PrefixCache, _Live,
                                            _PageSetupMixin, _PromptReq)
from znicz_tpu_torch.serving.fleet import ReplicaGroup
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger

__all__ = ["DisaggEngine", "Handoff"]

#: distinguishes same-named engines in the registry's labels
_DISAGG_SEQ = itertools.count()


class _DisaggReq(_PromptReq):
    """A queued prompt and its handoff retries."""

    __slots__ = ("handoff_retries",)

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.handoff_retries = 0


class Handoff:
    """One prefill→decode transfer: the request, its first sampled
    token, the prompt blocks' K/V pages as host arrays (one page set a
    block), and the LSTM carry rows when the chain has any.  Host arrays,
    not device tensors: the payload outlives the prefill worker's pages
    (released as soon as the export lands) and could cross hosts."""

    __slots__ = ("req", "first_token", "pages", "carries")

    def __init__(self, req: _DisaggReq, first_token: int,
                 pages: list, carries: list | None) -> None:
        self.req = req
        self.first_token = int(first_token)
        self.pages = pages
        self.carries = carries

    @property
    def n_pages(self) -> int:
        return len(self.pages)


class _Worker(Logger):
    """What both pools' replicas share: a private cache from the model's
    planned ones, a thread, and the cache's return to the model once the
    thread drained.  No ``__slots__``: :class:`ReplicaGroup` assigns
    replica identity attributes."""

    kind = "worker"

    def __init__(self, parent: "DisaggEngine", wid: int) -> None:
        super().__init__()
        self.parent = parent
        self.wid = wid
        self.model = parent.model
        self.cache = parent.model.make_cache()
        self.served = 0
        self.breaker_state = "closed"
        self._stop = False
        self._thread: threading.Thread | None = None

    def start(self) -> "_Worker":
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.kind}-w{self.wid}", daemon=True)
        self._thread.start()
        return self

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain (the loop ends once its work is done), then give the
        cache back; a worker still running past ``timeout`` keeps it."""
        with self.parent._cond:
            self._stop = True
            self.parent._cond.notify_all()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)
            if thread.is_alive():
                self.warning("%s worker %d still running after %.0fs: its "
                             "cache stays held", self.kind, self.wid,
                             timeout)
                return
        if self.cache is not None:
            self._release()
            self.model.release_cache(self.cache)
            self.cache = None

    def _release(self) -> None:
        pass


class _PrefillWorker(_PageSetupMixin, _Worker):
    """One prefill-pool replica: a private cache, prefix trie and spill
    tier, serving one prompt at a time off the parent's shared queue."""

    kind = "prefill"

    def __init__(self, parent: "DisaggEngine", wid: int) -> None:
        super().__init__(parent, wid)
        self._obs_id = parent._obs_id
        self.prefix = (PrefixCache(parent.model.page_tokens)
                       if parent.prefix_cache_enabled else None)
        self._spill = None
        if self.prefix is not None and parent.spill_pages > 0:
            from znicz_tpu_torch.memory import HostPageTier
            self._spill = HostPageTier(parent.model.page_shapes(),
                                       parent.spill_pages,
                                       targets=parent.model.page_stage)
        # the pool's workers feed the engine's children: a scrape reads
        # one engine id, not one a replica
        self._m_prefix_hit = parent._m_prefix_hit
        self._m_prefix_miss = parent._m_prefix_miss
        self._m_tok_shared = parent._m_tok_shared
        self._m_tok_computed = parent._m_tok_computed
        self._m_mig_spill = parent._m_mig_spill
        self._m_mig_restore = parent._m_mig_restore

    def _kv_cache(self):
        return self.cache

    def _release(self) -> None:
        if self.prefix is not None:
            self.prefix.clear(self.cache, tier=self._spill)
        if self._spill is not None:
            self._spill.shutdown()

    def _loop(self) -> None:
        parent = self.parent
        while True:
            with parent._cond:
                while not self._stop and not parent._prefill_q:
                    parent._cond.wait(0.05)
                if not parent._prefill_q:
                    if self._stop:
                        return  # drained: a shrink loses no request
                    continue
                req = parent._prefill_q.popleft()
            now = time.monotonic()
            if req.expired(now):
                # the TTFT deadline passed in the queue: fail fast, the
                # prompt never costs a prefill
                parent._refund(req)
                parent._m_rejected.inc()
                req.trace.event("deadline_evicted", engine=parent._obs_id)
                parent._finish_trace(req, "expired")
                waited_ms = (now - req.t_submit - req.pause_s) * 1e3
                if not req.future.done():
                    req.future.set_exception(DeadlineExceeded(
                        f"TTFT deadline passed after {waited_ms:.0f}ms in "
                        f"the prefill queue"))
                continue
            self._serve(req)

    def _serve(self, req: _DisaggReq) -> None:
        parent = self.parent
        model = self.model
        cache = self.cache
        parent._end_phase(req, "queue")
        req.trace.phase_begin("prefill")
        slot = cache.acquire()
        try:
            # the prompt's blocks only (max_new=0): the decode worker
            # reserves the generation span, so page pressure here is the
            # trie's, absorbed by spills and eviction
            matched = self._setup_pages(slot, req.tokens, 0)
            logits = model.run_prefill(req.tokens[matched:], slot, matched,
                                       cache=cache)
        except Exception as exc:  # noqa: BLE001 — isolate the prompt
            cache.release_slot_pages(slot)
            cache.release(slot)
            parent._refund(req)
            parent._m_rejected.inc()
            parent._finish_trace(req, "failed")
            self.warning("prefill failed: %s", exc)
            if not req.future.done():
                req.future.set_exception(exc)
            return
        if self.prefix is not None:
            self.prefix.insert(req.tokens, cache.tables[slot], cache)
        token = parent._sample(logits, parent._worker_rng(self.wid))
        parent._end_phase(req, "prefill", tokens=req.n, worker=self.wid)
        ttft = time.monotonic() - req.t_submit - req.pause_s
        req.future.ttft_s = ttft
        parent._m_ttft.observe(ttft)
        parent._ttft_win.append(ttft)
        parent._m_tok_prompt.inc(req.n)
        parent._m_tok_gen.inc()
        self.served += 1
        if (parent.eos_token is not None and token == parent.eos_token) \
                or req.max_new <= 1:
            cache.release_slot_pages(slot)
            cache.release(slot)
            parent._refund(req)
            parent._m_served.inc()
            parent._finish_trace(req, "ok")
            if not req.future.done():
                req.future.set_result(np.asarray([token], np.int32))
            return
        # the handoff phase opens here and keeps its first begin across a
        # dropped-handoff retry, so the whole retry loop is charged to
        # the hop that lost the payload
        req.trace.phase_begin("handoff")
        nblocks = -(-req.n // model.page_tokens)
        pages = model.export_pages(cache.tables[slot, :nblocks], cache=cache)
        carries = (model.export_carry(slot, cache=cache)
                   if model.has_lstm else None)
        # the exports are fenced: the pages may go back to the free list
        # (the trie's pins keep shareable blocks for the next prompt)
        cache.release_slot_pages(slot)
        cache.release(slot)
        parent._route_handoff(Handoff(req, token, pages, carries))


class _DecodeWorker(_Worker):
    """One decode-pool replica: a private cache, an inbox of handoffs
    and the continuous token loop.  Handoffs are accepted between steps,
    bounded by the free slots: the fused engine's admission point, less
    the prefill."""

    kind = "decode"

    def __init__(self, parent: "DisaggEngine", wid: int) -> None:
        super().__init__(parent, wid)
        self.inbox: deque = deque()
        self._live: list[_Live] = []

    def inbox_age(self) -> float:
        """Age of the oldest handoff not yet accepted (the decode pool's
        scaling signal); a racy peek, as a scrape may be."""
        try:
            h = self.inbox[0]
        except IndexError:
            return 0.0
        return max(0.0, time.monotonic() - h.req.t_submit - h.req.pause_s)

    def _loop(self) -> None:
        parent = self.parent
        while True:
            intake: list[Handoff] = []
            with parent._cond:
                if not self.inbox and not self._live:
                    if self._stop:
                        return
                    parent._cond.wait(0.05)
                free = self.cache.free_slots
                while self.inbox and len(intake) < free:
                    intake.append(self.inbox.popleft())
            for h in intake:
                self._accept(h)
            if self._live:
                self._step()

    def _accept(self, h: Handoff) -> None:
        """Land one handoff: reserve the whole worst-case span in fresh
        private pages, upload the payload through the staging ring into
        them, and join the live batch."""
        parent = self.parent
        model = self.model
        cache = self.cache
        req = h.req
        slot = cache.acquire()
        span = min(req.n + req.max_new, model.max_t)
        nblocks = -(-span // model.page_tokens)
        try:
            for b in range(nblocks):
                cache.new_block(slot, b)
        except PoolExhausted:
            cache.release_slot_pages(slot)
            cache.release(slot)
            with parent._cond:
                if self._live:
                    # draining lanes free pages: retry at the next step
                    self.inbox.appendleft(h)
                    return
            # an empty cache cannot hold it, ever
            parent._refund(req)
            parent._m_rejected.inc()
            parent._finish_trace(req, "failed")
            if not req.future.done():
                req.future.set_exception(PoolExhausted(
                    f"handoff of {req.n} prompt tokens cannot fit the "
                    f"decode pool ({cache.pool_pages} pages)"))
            return
        for b, pages in enumerate(h.pages):
            if not pages:
                continue  # a chain without page pools ships empty sets
            with model.dispatch_lock:  # the staging tensors are shared
                staged = parent._stager.upload(pages)
                model.page_in(staged, int(cache.tables[slot, b]),
                              cache=cache)
        if h.carries is not None:
            with model.dispatch_lock:
                rows = parent._carry_stager.upload(h.carries)
                model.carry_in(rows, slot, cache=cache)
        parent._m_mig_handoff.inc(h.n_pages)
        parent._end_phase(req, "handoff", pages=h.n_pages, worker=self.wid,
                          retries=req.handoff_retries)
        req.trace.phase_begin("decode")
        self._live.append(_Live(req, slot, h.first_token))

    def _free_lane(self, s: _Live) -> None:
        self.cache.release_slot_pages(s.slot)
        self.cache.release(s.slot)
        self.parent._refund(s.req)

    def _finish(self, s: _Live) -> None:
        parent = self.parent
        self._free_lane(s)
        parent._m_served.inc()
        self.served += 1
        parent._end_phase(s.req, "decode", tokens=len(s.generated))
        parent._finish_trace(s.req, "ok")
        if not s.req.future.done():
            s.req.future.set_result(np.asarray(s.generated, np.int32))

    def _fail(self, s: _Live, exc: Exception) -> None:
        self._free_lane(s)
        self.parent._finish_trace(s.req, "failed")
        if not s.req.future.done():
            s.req.future.set_exception(exc)

    def _step(self) -> None:
        parent = self.parent
        live = self._live
        tokens = np.asarray([s.generated[-1] for s in live], np.int32)
        slots = np.asarray([s.slot for s in live], np.int32)
        positions = np.asarray([s.pos for s in live], np.int32)
        try:
            logits = self.model.run_decode(tokens, slots, positions,
                                           cache=self.cache)
        except Exception as exc:  # noqa: BLE001 — the step is shared
            self.warning("decode step failed for %d lanes: %s", len(live),
                         exc)
            for s in live:
                self._fail(s, exc)
            self._live = []
            return
        now = time.monotonic()
        rng = parent._worker_rng(self.wid)
        still: list[_Live] = []
        for i, s in enumerate(live):
            token = parent._sample(logits[i], rng)
            dt = now - s.t_last
            s.t_last = now
            s.pos += 1
            s.generated.append(int(token))
            parent._m_token.observe(dt)
            parent._token_win.append(dt)
            parent._m_tok_gen.inc()
            if ((parent.eos_token is not None
                 and int(token) == parent.eos_token)
                    or len(s.generated) >= s.req.max_new
                    or s.pos >= self.model.max_t):
                self._finish(s)
            else:
                still.append(s)
        self._live = still


class DisaggEngine(Logger):
    """The prefill/decode-disaggregated token server.

    The :class:`~znicz_tpu_torch.serving.decode.DecodeEngine` contract
    (``submit`` → a future of the generated ids, ``generate`` sync;
    greedy token-identical to the fused engine), another data plane: a
    prefill :class:`ReplicaGroup` and a decode :class:`ReplicaGroup` over
    one warmed :class:`DecodeModel`, joined by host-array page handoffs
    (the module docstring has the design).  Knobs:

    - ``prefill_replicas`` / ``decode_replicas``: the pools' sizes at
      start; ``max_*_replicas`` bound them, and with them the caches the
      model plans (given a :class:`DecodeModel`, its ``n_caches`` must
      cover both bounds);
    - ``spill_pages``: each prefill worker's host-DRAM tier, in pages
      (``engine.kv_spill_pages``; 0, the default, leaves it out);
    - ``handoff_retry_budget``: dropped handoffs retried before the
      request fails (the fault site ``disagg.handoff_drop``);
    - ``autoscale``: a :class:`~znicz_tpu_torch.serving.fleet.
      PoolAutoscaler` on the maintenance thread, scaling each pool on its
      own ``znicz_serving_queue_age_seconds`` child.

    The device is the model's: the card unless ``device="cpu"``."""

    def __init__(self, model, *, prefill_replicas: int = 1,
                 decode_replicas: int = 1,
                 max_prefill_replicas: int = 4,
                 max_decode_replicas: int = 4,
                 max_slots: int = 4, max_t: int = 64,
                 max_prompt: int | None = None,
                 prompt_align: int = 8,
                 max_new_tokens: int = 32,
                 eos_token: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 max_queue: int = 256,
                 page_tokens: int | None = None,
                 pool_tokens: int | None = None,
                 prefix_cache: bool | None = None,
                 spill_pages: int | None = None,
                 max_queue_tokens: int | None = None,
                 handoff_retry_budget: int = 1,
                 autoscale: bool = False,
                 queue_age_up_s: float = 0.25,
                 idle_down_s: float = 5.0,
                 device=None) -> None:
        super().__init__()
        n_caches = int(max_prefill_replicas) + int(max_decode_replicas)
        if not isinstance(model, DecodeModel):
            model = DecodeModel(model, max_slots=max_slots, max_t=max_t,
                                max_prompt=max_prompt,
                                prompt_align=prompt_align, device=device,
                                paged=True, page_tokens=page_tokens,
                                pool_tokens=pool_tokens, spec_k=0,
                                n_caches=n_caches)
        if not model.paged:
            raise ValueError(
                "disaggregation needs the paged cache: the handoff ships "
                "pages, a flat cache has none")
        if model.n_caches < n_caches:
            raise ValueError(
                f"the model plans {model.n_caches} caches beside its own; "
                f"the pools may reach {n_caches} replicas "
                f"(max_prefill_replicas + max_decode_replicas): build it "
                f"with DecodeModel(n_caches={n_caches})")
        self.model = model
        if prefix_cache is None:
            prefix_cache = bool(root.common.engine.get("prefix_cache", True))
        # an LSTM's carry sums up its whole prefix: nothing to share
        self.prefix_cache_enabled = bool(prefix_cache and not model.has_lstm)
        if spill_pages is None:
            spill_pages = int(root.common.engine.get("kv_spill_pages", 0))
        self.spill_pages = int(spill_pages)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = eos_token
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.max_queue = int(max_queue)
        self.handoff_retry_budget = max(0, int(handoff_retry_budget))
        budget = (int(max_queue_tokens) if max_queue_tokens
                  else 16 * model.pool_tokens)
        self._token_budget = TokenBudget(budget)
        wf_name = model.model.manifest.get("workflow", "model")
        self._obs_id = f"{wf_name}#disagg{next(_DISAGG_SEQ)}"
        obs = self._obs_id
        self._m_submitted = _metrics.serving_requests(obs, "submitted")
        self._m_served = _metrics.serving_requests(obs, "served")
        self._m_rejected = _metrics.serving_requests(obs, "rejected")
        self._m_ttft = _metrics.serving_ttft_seconds(obs)
        self._m_token = _metrics.serving_token_seconds(obs)
        self._m_tok_prompt = _metrics.serving_tokens(obs, "prompt")
        self._m_tok_gen = _metrics.serving_tokens(obs, "generated")
        self._m_prefix_hit = _metrics.prefix_cache_events(obs, "hit")
        self._m_prefix_miss = _metrics.prefix_cache_events(obs, "miss")
        self._m_tok_shared = _metrics.prefix_tokens(obs, "shared")
        self._m_tok_computed = _metrics.prefix_tokens(obs, "computed")
        self._m_mig_spill = _metrics.kv_page_migrations(obs, "spill")
        self._m_mig_restore = _metrics.kv_page_migrations(obs, "restore")
        self._m_mig_handoff = _metrics.kv_page_migrations(obs, "handoff")
        _metrics.kv_spill_pages(obs).set_function(self._spill_used)
        _metrics.serving_queue_age_seconds(
            obs, pool="prefill").set_function(self._prefill_queue_age)
        _metrics.serving_queue_age_seconds(
            obs, pool="decode").set_function(self._decode_queue_age)
        self._ttft_win: deque = deque(maxlen=4096)
        self._token_win: deque = deque(maxlen=4096)
        # per-phase windows behind the znicz_phase_p99_seconds gauges,
        # fed by the same phase_end() the request traces record
        self._phase_win: dict[str, deque] = {
            p: deque(maxlen=4096)
            for p in ("queue", "prefill", "handoff", "decode")}
        for _p, _win in self._phase_win.items():
            _metrics.phase_p99_seconds(obs, _p).set_function(
                lambda w=_win: _metrics.window_p99(w))
        _metrics.phase_p99_seconds(obs, "ttft").set_function(
            lambda w=self._ttft_win: _metrics.window_p99(w))
        _metrics.phase_p99_seconds(obs, "token").set_function(
            lambda w=self._token_win: _metrics.window_p99(w))
        self._federator = None
        self._prefill_q: deque = deque()
        self._cond = threading.Condition()
        self._rng_lock = threading.Lock()
        self._rngs: dict[int, np.random.Generator] = {}
        self.handoffs_total = 0
        self.handoff_drops = 0
        self.handoff_retries_total = 0
        self.warmup_compiles = 0
        self.warmup_seconds = 0.0
        self._started = False
        self._wid = itertools.count()
        self.prefill_pool = ReplicaGroup(
            obs, "prefill", "v0",
            lambda: _PrefillWorker(self, next(self._wid)),
            target=int(prefill_replicas),
            max_replicas=int(max_prefill_replicas))
        self.decode_pool = ReplicaGroup(
            obs, "decode", "v0",
            lambda: _DecodeWorker(self, next(self._wid)),
            target=int(decode_replicas),
            max_replicas=int(max_decode_replicas))
        self._stager = None
        self._carry_stager = None
        self._autoscaler = None
        self._maint: threading.Thread | None = None
        self._maint_stop = threading.Event()
        if autoscale:
            from znicz_tpu_torch.serving.fleet import PoolAutoscaler
            self._autoscaler = PoolAutoscaler(
                {"prefill": self.prefill_pool, "decode": self.decode_pool},
                obs, queue_age_up_s=queue_age_up_s, idle_down_s=idle_down_s)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "DisaggEngine":
        if self._started:
            return self
        from znicz_tpu_torch.memory import PageStager
        t0 = time.monotonic()
        # one warm-up serves both pools: every worker's cache is a
        # partition of the model's arena, so a later scale-up captures
        # nothing
        self.warmup_compiles = self.model.warmup(
            prefix_cache=self.prefix_cache_enabled, page_io=True)
        self.warmup_seconds = time.monotonic() - t0
        self._stager = PageStager(self.model.page_shapes(),
                                  device=self.model.device,
                                  targets=self.model.page_stage)
        if self.model.has_lstm:
            self._carry_stager = PageStager(self.model.carry_shapes(),
                                            targets=self.model.carry_stage)
        self._started = True
        if _metrics.enabled() and self._federator is None:
            # the maintenance thread doubles as the metrics folder: one
            # in-process source re-labels this engine's series under
            # their {process, pool} children
            from znicz_tpu_torch.observe.federation import Federator
            self._federator = Federator(self._obs_id)
            self._federator.add_registry(
                "self", pool_of=lambda eng: ("" if eng == self._obs_id
                                             else None))
        self.prefill_pool.scale_to(self.prefill_pool.target, reason="start")
        self.decode_pool.scale_to(self.decode_pool.target, reason="start")
        if self._autoscaler is not None or self._federator is not None:
            self._maint_stop.clear()
            self._maint = threading.Thread(target=self._maintenance,
                                           name="disagg-maint", daemon=True)
            self._maint.start()
        self.info(
            "disagg '%s': %d programs made resident in %.2fs (graphed=%s), "
            "pools prefill:%d + decode:%d (slots=%d a cache, page_tokens=%d,"
            " prefix_cache=%s, spill_pages=%d a prefill worker)",
            self.model.model.manifest.get("workflow", "?"),
            self.warmup_compiles, self.warmup_seconds, self.model.graphed,
            self.prefill_pool.live(), self.decode_pool.live(),
            self.model.max_slots, self.model.page_tokens,
            self.prefix_cache_enabled, self.spill_pages)
        return self

    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain both pools in dataflow order: the prefill workers finish
        the prompt queue (routing their handoffs), then the decode
        workers every inbox and live lane."""
        if self._maint is not None:
            self._maint_stop.set()
            self._maint.join(timeout=10.0)
            self._maint = None
        targets = (self.prefill_pool.target, self.decode_pool.target)
        self.prefill_pool.scale_to(0, reason="shutdown")
        self.decode_pool.scale_to(0, reason="shutdown")
        # a later start() brings back the configured sizes
        self.prefill_pool.target, self.decode_pool.target = targets
        for stager in (self._stager, self._carry_stager):
            if stager is not None:
                stager.shutdown()
        self._stager = self._carry_stager = None
        if self._federator is not None:
            self._federator.close()
            self._federator = None
        self._started = False

    def __enter__(self) -> "DisaggEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def _maintenance(self) -> None:
        while not self._maint_stop.wait(0.05):
            if self._autoscaler is not None:
                self._autoscaler.tick()
            if self._federator is not None:
                self._federator.scrape()

    # ------------------------------------------------------------------
    # the request path
    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int | None = None,
               deadline_ms: float | None = None) -> Future:
        """Queue a prompt; a future of the generated ids (the first
        sampled token on).  Admission counts tokens: the queue is bounded
        by the work it holds, and the reservation travels with the
        request across the handoff."""
        if not self._started:
            raise RuntimeError("engine not started")
        tokens = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        if tokens.shape[0] < 1:
            raise ValueError("empty prompt")
        if tokens.shape[0] > self.model.max_prompt:
            raise ValueError(f"prompt of {tokens.shape[0]} tokens exceeds "
                             f"max_prompt {self.model.max_prompt}")
        req = _DisaggReq(tokens, max_new_tokens if max_new_tokens is not None
                         else self.max_new_tokens, deadline_ms)
        with self._cond:
            if len(self._prefill_q) >= self.max_queue:
                self._m_rejected.inc()
                self._finish_trace(req, "shed")
                raise QueueFull(
                    f"prefill queue full ({len(self._prefill_q)} prompts "
                    f"pending, limit {self.max_queue})")
            want = req.n + req.max_new
            if not self._token_budget.try_acquire(want):
                self._m_rejected.inc()
                self._finish_trace(req, "shed")
                raise QueueFull(
                    f"token budget full ({self._token_budget.used} of "
                    f"{self._token_budget.capacity} tokens held; request "
                    f"wants {want})")
            req.charged = want
            self._prefill_q.append(req)
            self._cond.notify_all()
        self._m_submitted.inc()
        return req.future

    def generate(self, prompt, timeout: float | None = None,
                 **kwargs) -> np.ndarray:
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    def _refund(self, req: _PromptReq) -> None:
        if req.charged:
            self._token_budget.release(req.charged)
            req.charged = 0

    def _end_phase(self, req: _PromptReq, phase: str, **args) -> float:
        """Close one trace phase; the same duration feeds the phase's
        windowed-p99 gauge."""
        dur = req.trace.phase_end(phase, engine=self._obs_id, **args)
        if dur > 0.0:
            win = self._phase_win.get(phase)
            if win is not None:
                win.append(dur)
        return dur

    def _finish_trace(self, req: _PromptReq, outcome: str) -> None:
        _metrics.trace_requests(self._obs_id, outcome).inc()
        req.trace.finish(outcome)

    def _sample(self, logits: np.ndarray, rng: np.random.Generator) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits))
        z = logits / self.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def _worker_rng(self, wid: int) -> np.random.Generator:
        """Worker ``wid``'s generator, seeded from the engine's seed."""
        with self._rng_lock:
            rng = self._rngs.get(wid)
            if rng is None:
                rng = np.random.default_rng(self.seed * 1009 + wid)
                self._rngs[wid] = rng
            return rng

    # ------------------------------------------------------------------
    # the handoff (a prefill worker's thread → a decode worker's inbox)
    # ------------------------------------------------------------------
    def _route_handoff(self, h: Handoff) -> None:
        req = h.req
        if _faults.fire("disagg.handoff_drop") is not None:
            # the payload is lost in transit after the prefill worker
            # released its pages: redo the prefill (a prefix hit now, the
            # trie kept the blocks)
            self.handoff_drops += 1
            req.trace.event("handoff_drop", engine=self._obs_id,
                            retries=req.handoff_retries)
            if req.handoff_retries >= self.handoff_retry_budget:
                self._refund(req)
                self._m_rejected.inc()
                self._finish_trace(req, "failed")
                if not req.future.done():
                    req.future.set_exception(_faults.FaultInjected(
                        f"handoff dropped {req.handoff_retries + 1} times "
                        f"(retry budget {self.handoff_retry_budget})"))
                return
            req.handoff_retries += 1
            self.handoff_retries_total += 1
            _metrics.recoveries("handoff_retry").inc()
            self.warning("handoff dropped (fault injected) — retrying the "
                         "prompt of %d tokens on a fresh prefill (%d/%d)",
                         req.n, req.handoff_retries,
                         self.handoff_retry_budget)
            with self._cond:
                # the front of the queue: the reservation is still held
                # and the work still pending
                self._prefill_q.appendleft(req)
                self._cond.notify_all()
            return
        while True:
            worker = self.decode_pool.pick()
            if worker is None:
                self._refund(req)
                self._m_rejected.inc()
                self._finish_trace(req, "failed")
                if not req.future.done():
                    req.future.set_exception(Overloaded(
                        "no live decode replica to accept the handoff"))
                return
            with self._cond:
                # a replica taken out of the pool after the pick may have
                # drained already: pick again
                if not worker._stop:
                    worker.inbox.append(h)
                    self.handoffs_total += 1
                    self._cond.notify_all()
                    return

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _prefill_queue_age(self) -> float:
        try:
            req = self._prefill_q[0]
        except IndexError:
            return 0.0
        return max(0.0, time.monotonic() - req.t_submit - req.pause_s)

    def _decode_queue_age(self) -> float:
        return max((w.inbox_age() for w in self.decode_pool.engines()),
                   default=0.0)

    def _spill_used(self) -> int:
        return sum(w._spill.used for w in self.prefill_pool.engines()
                   if getattr(w, "_spill", None) is not None)

    @property
    def breaker_state(self) -> str:
        return "closed"

    def ready(self) -> bool:
        return bool(self._started and self.prefill_pool.live()
                    and self.decode_pool.live())

    def balanced(self) -> bool:
        """Exactly-once accounting across submit → prefill → handoff →
        decode: true when idle with every reservation returned."""
        return self._token_budget.balanced()

    def stats(self) -> dict:
        pct = _metrics._percentile

        def window(win):
            vals = sorted(win)
            if not vals:
                return {}
            return {"p50": round(1e3 * pct(vals, 50), 3),
                    "p95": round(1e3 * pct(vals, 95), 3),
                    "p99": round(1e3 * pct(vals, 99), 3),
                    "mean": round(1e3 * sum(vals) / len(vals), 3),
                    "window": len(vals)}

        model = self.model
        return {
            "engine": "decode-disagg" + ("-graphs" if model.graphed else ""),
            "pools": {
                "prefill": {"live": self.prefill_pool.live(),
                            "target": self.prefill_pool.target,
                            "queue_age_s": round(self._prefill_queue_age(),
                                                 4)},
                "decode": {"live": self.decode_pool.live(),
                           "target": self.decode_pool.target,
                           "queue_age_s": round(self._decode_queue_age(),
                                                4)},
            },
            "handoffs": {
                "total": self.handoffs_total,
                "dropped": self.handoff_drops,
                "retried": self.handoff_retries_total,
                "pages_moved": int(self._m_mig_handoff.value),
            },
            "prefix_cache": ({
                "hits": int(self._m_prefix_hit.value),
                "misses": int(self._m_prefix_miss.value),
                "shared_tokens": int(self._m_tok_shared.value),
                "computed_tokens": int(self._m_tok_computed.value),
                "spill_pages_used": self._spill_used(),
                "spill_capacity": self.spill_pages,
                "migrations": {
                    "spill": int(self._m_mig_spill.value),
                    "restore": int(self._m_mig_restore.value),
                },
            } if self.prefix_cache_enabled else None),
            "programs_compiled": model.compile_count,
            "programs_live": model.programs_live,
            "captures": model.captures,
            "caches": {"planned": model.n_caches,
                       "free": model.caches_free},
            "warmup_seconds": round(self.warmup_seconds, 3),
            "submitted": int(self._m_submitted.value),
            "served": int(self._m_served.value),
            "rejected": int(self._m_rejected.value),
            "queued_prompts": len(self._prefill_q),
            "ttft_ms": window(self._ttft_win),
            "token_ms": window(self._token_win),
            "token_budget": {
                "capacity": self._token_budget.capacity,
                "used": self._token_budget.used,
                "over_released": self._token_budget.over_released,
            },
        }

    def serving_status(self) -> dict:
        """``web_status.gather_status`` hook."""
        out = {"name": "disagg:"
               + self.model.model.manifest.get("workflow", "?"),
               "initialized": self._started,
               "stopped": not self._started}
        out.update(self.stats())
        return out
