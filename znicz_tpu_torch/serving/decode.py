"""Autoregressive decode serving: KV caches, the prefill/decode program
split and continuous token batching (port of
``znicz_tpu/serving/decode.py``).

Any exported causal LM bundle (``manifest["kind"] == "lm"``: a
token-first chain of embedding, pos_encoding, causal attention and LSTM
layers, then a position-independent head) becomes a token server built
from these pieces:

1. **KV caches.**  :class:`KVCache`, the flat layout: one (S+1, maxT, H,
   Dh) K and V array an attention layer and one (S+1, H) carry pair an
   LSTM, where S is ``max_slots`` and the extra row is the scratch slot
   that padded decode lanes write into.  :class:`PagedKVCache`, the
   paged layout (the default): K and V in a pool of ``page_tokens``-token
   pages addressed through a block table a sequence, the pool's last
   page the trash page that padded lanes and positions write into, and
   optionally int8 pages with one f32 scale a (token, head) row.  Both
   are allocated once, on the device, outside any CUDA graph's memory
   pool; every program writes them in place (``index_put_``,
   ``index_copy_``).  Page tables, refcounts and free lists stay numpy
   on the host.
   A model may plan more caches than its own (``n_caches``, the pools of
   :class:`~znicz_tpu_torch.serving.disagg.DisaggEngine`): they are
   partitions of one arena, the same device arrays with each cache's
   pages and slots at its own offsets, so one set of programs serves
   every cache and :meth:`DecodeModel.make_cache` captures nothing.
2. **Prefix sharing.**  :class:`PrefixCache`, a radix trie over
   block-aligned prompt prefixes: a request with a cached prefix shares
   its full pages by reference, copies a partly matched boundary page
   before its divergent tail lands (copy on write), and prefills only
   the tail.  A weight swap clears it.  Behind it, optionally, a
   host-DRAM tier (:class:`~znicz_tpu_torch.memory.HostPageTier`): under
   pool pressure a cold block spills to a page-locked host frame and
   stays matchable, and a match restores it through the staging ring
   and the ``page_in`` program.
3. **Programs.**  :class:`DecodeModel` plans the chain and owns eight
   program families: prefill (keyed by the prompt bucket), decode (the
   live-batch bucket), paged prefill (prompt bucket, block bucket),
   paged decode (batch bucket, block bucket), the window that verifies
   speculative drafts and admits a wave of prefix-hit tails (batch
   bucket, window length, block bucket), the page copy, and the page
   and carry writes (``page_in``, ``carry_in``: one staged page set into
   a page, one slot's LSTM carry rows into a slot) that land a spill
   restore or a prefill→decode handoff.  On the card
   each program is one CUDA graph, captured at :meth:`DecodeModel.warmup`
   (``DecodeEngine.start()`` calls it), or on a key's first use past the
   warmed grid, after an eager warm-up on a side stream whose inputs
   route every write to the scratch slot or the trash page.  A program's
   inputs (tokens, slots, positions, tables, starts, lengths) are views
   of one int32 device buffer that the host fills with one copy before a
   replay.  The graphs of one model share one memory pool, so each
   dispatch copies its logits to the host before the next, under the
   model's dispatch lock (the disaggregated pools dispatch from several
   threads).  A replay refuses when a cache, a weight, a staging tensor
   or the encoding table it was captured over has been rebound to
   another tensor.  A failed capture raises,
   naming the program; there is no eager fallback and no switch.  The
   CPU runs the same bodies eagerly (:attr:`DecodeModel.graphed`).
   Nothing in a body reads a device value on the host: every index that
   depends on a slot, a position or a length is a device tensor used in a
   gather or an ``index_put_``, and each stays in range by construction
   (padded lanes point at the scratch slot or the trash page, positions
   past a table go to the trash page, the encoding table holds twice
   ``max_t`` rows and is read through a clamp).  Decode math is f32
   whatever the bundle's dtype, TF32 off; a head layer rounds its
   product operands as the unit does (``mxu_dot``).
4. **Continuous token batching.**  :class:`DecodeEngine` admits queued
   prompts into the in-flight batch between token steps (``"static"``
   admission waits for the batch to drain), evicts a sequence the step
   it finishes (EOS, its token budget, or ``max_t``), speculates with a
   small flat drafter and verifies its drafts in one window (greedy
   verification emits exactly the non-speculative tokens), samples on
   the host from a seeded generator, bounds TTFT with deadlines, sheds
   through the circuit breaker (failures and pool exhaustion alike),
   bounds its queue by tokens (:class:`TokenBudget`) and priority
   classes, traces each request's queue, prefill and decode phases, and
   hot-swaps its weights after draining the lanes of the old ones.

The reference's persisted decode programs have no counterpart: they
are CUDA graphs here, captured at ``start()`` (the port's store,
:mod:`~znicz_tpu_torch.serving.aot_cache`, holds the kernel
libraries).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from znicz_tpu_torch.observe import metrics as _metrics
from znicz_tpu_torch.observe import recorder as _recorder
from znicz_tpu_torch.observe import tracing as _tracing
from znicz_tpu_torch.resilience import faults as _faults
from znicz_tpu_torch.serving import quantize as _quantize
from znicz_tpu_torch.serving.batcher import (_CLOSED, _HALF_OPEN, _OPEN,
                                             _STATE_CODE, DeadlineExceeded,
                                             Overloaded, PriorityQueue,
                                             QueueFull, TokenBudget)
from znicz_tpu_torch.serving.buckets import bucket_for, ladder, next_pow2
from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger

__all__ = ["DecodeModel", "DecodeEngine", "KVCache", "PagedKVCache",
           "PrefixCache", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """The paged KV pool has no free page for a required block.  The
    engine turns it into breaker load-shedding (queued prompts) or a
    refused request (a prompt no drained pool can hold); it never kills
    a neighbor."""


#: distinguishes same-named engines in the registry's labels
_DECODE_SEQ = itertools.count()

#: layer kinds the decode planner can step incrementally
_SEQ_KINDS = ("embedding", "pos_encoding", "attention", "lstm")
_HEAD_KINDS = ("all2all", "all2all_tanh", "all2all_relu",
               "all2all_str", "all2all_sigmoid", "softmax")


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch dtype as torch's."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class _Op:
    """One planned chain step: the unit (its configuration), the export
    keys of its weights and, for stateful layers, its cache array
    indices.  The weights are not baked into the op: every body reads
    :attr:`DecodeModel._weights`, which a swap writes in place."""

    __slots__ = ("kind", "unit", "wkeys", "aux", "table")

    def __init__(self, kind, unit, wkeys=(), aux=None, table=None):
        self.kind = kind
        self.unit = unit
        self.wkeys = tuple(wkeys)  # export keys (layer<i>_<attr>)
        self.aux = aux or {}       # cache indices
        self.table = table         # pos_encoding: the (2·maxT, D) table


def _dq_leaves(w) -> tuple:
    """One op's weights for a body: an ``(int8 q, f32 scale)`` pair
    becomes ``q·scale`` in f32 (exact, as the reference's), any other
    leaf passes through."""
    return tuple(leaf[0].float() * leaf[1] if isinstance(leaf, tuple)
                 else leaf for leaf in w)


class KVCache:
    """The flat decode state of one replica: K/V and carry arrays (one
    row a slot plus the scratch row) and the host's slot free list.

    A reused slot needs no zeroing: prefill writes ``[0, t_bucket)`` of
    it, and every step masks positions past its own, so an earlier
    tenant's rows are never read."""

    def __init__(self, specs: list[tuple[str, tuple]], max_slots: int,
                 dtype=torch.float32, device="cpu") -> None:
        self.max_slots = int(max_slots)
        #: the scratch row padded decode lanes write into
        self.trash_slot = self.max_slots
        self.specs = list(specs)
        self.arrays: list = [
            torch.zeros((self.max_slots + 1,) + tuple(shape),
                        dtype=_torch_dtype(dtype), device=device)
            for _name, shape in specs]
        self._free = list(range(self.max_slots))

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        return self._free.pop()

    def release(self, slot: int) -> None:
        self._free.append(slot)

    def nbytes(self) -> int:
        return int(sum(a.numel() * a.element_size() for a in self.arrays))


class PagedKVCache:
    """Paged decode state: K/V page pools (one pair an attention layer,
    int8 pools with f32 scale pools when quantized), slot-indexed LSTM
    carries, and the host's block tables, refcounts and free lists.

    A pool is ``(pool_pages + 1, page_tokens, ...)``: the last page is
    the trash page.  A sequence in slot ``s`` owns ``tables[s]``, one
    page id a block of its positions, ``trash_page`` where none is
    allocated.  A page's ``ref`` counts its holders (each table mapping
    a block to it, and the prefix trie's pin); it is freed at zero.  A
    shared page (``ref > 1`` or pinned) is never written: a sequence
    writes at its append position, past every shared full block, and the
    boundary block of a partial prefix match is copied before its tail
    lands.  All mutation happens on the scheduler thread.

    The cache may be one of ``n_caches`` partitions of an arena: the
    arena's arrays hold ``n_caches · pool_pages`` pages and
    ``n_caches · max_slots`` slots and one trash page and slot, and
    partition ``index`` owns the pages from ``page_base`` and the slots
    from ``slot_base``.  Its host bookkeeping is its own and counts from
    0, as a lone cache's does; :meth:`dev_pages` and :meth:`dev_slots`
    turn its ids into the arena's for a program's operands.  Partitions
    share one list of arrays, so a rebinding shows in every one."""

    def __init__(self, specs: list[tuple], max_slots: int, page_tokens: int,
                 max_blocks: int, pool_pages: int, dtype=torch.float32,
                 device="cpu", n_caches: int = 1, index: int = 0,
                 arena: "PagedKVCache | None" = None) -> None:
        # specs: (name, kind, shape) or (name, kind, shape, dtype)
        self.max_slots = int(max_slots)
        self.trash_slot = self.max_slots
        self.page_tokens = int(page_tokens)
        self.max_blocks = int(max_blocks)
        self.pool_pages = int(pool_pages)
        self.trash_page = self.pool_pages
        self.specs = list(specs)
        self.n_caches = int(n_caches)
        self.index = int(index)
        if not 0 <= self.index < self.n_caches:
            raise ValueError(f"cache {index} outside an arena of "
                             f"{n_caches}")
        self.page_base = self.index * self.pool_pages
        self.slot_base = self.index * self.max_slots
        #: the arena's trash page and scratch slot
        self.dev_trash_page = self.n_caches * self.pool_pages
        self.dev_trash_slot = self.n_caches * self.max_slots
        if arena is not None:
            self.arrays: list = arena.arrays
        else:
            arrays = []
            for spec in specs:
                kind, shape = spec[1], spec[2]
                sdtype = _torch_dtype(spec[3] if len(spec) > 3 else dtype)
                if kind == "page":
                    lead = (self.dev_trash_page + 1, self.page_tokens)
                else:  # slot-indexed (LSTM carries)
                    lead = (self.dev_trash_slot + 1,)
                arrays.append(torch.zeros(lead + tuple(shape),
                                          dtype=sdtype, device=device))
            self.arrays = arrays
        #: indices of the page pools: what a copy on write copies
        self.pool_indices = tuple(i for i, s in enumerate(specs)
                                  if s[1] == "page")
        #: slot-indexed arrays (LSTM carries)
        self.slot_indices = tuple(i for i, s in enumerate(specs)
                                  if s[1] != "page")
        self.tables = np.full((self.max_slots + 1, self.max_blocks),
                              self.trash_page, np.int32)
        self.ref = np.zeros(self.pool_pages, np.int64)
        self._free_pages = list(range(self.pool_pages - 1, -1, -1))
        self._free = list(range(self.max_slots))

    # -- slots (the flat cache's protocol) -------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        return self._free.pop()

    def release(self, slot: int) -> None:
        self._free.append(slot)

    # -- pages -----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    def pages_used(self) -> int:
        return self.pool_pages - len(self._free_pages)

    def alloc_page(self) -> int:
        if not self._free_pages:
            raise PoolExhausted(
                f"KV page pool exhausted ({self.pool_pages} pages "
                f"x {self.page_tokens} tokens all held)")
        pid = self._free_pages.pop()
        self.ref[pid] = 1
        return pid

    def free_page(self, pid: int) -> None:
        self._free_pages.append(pid)

    def ref_dec(self, pid: int) -> None:
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self.free_page(pid)

    def share_block(self, slot: int, block: int, pid: int) -> None:
        """Map ``block`` of ``slot`` to a live page by reference.  A
        zero-ref page is on the free list: re-refing it here would let
        ``alloc_page`` hand it out again, so callers pin matched pages
        before anything can drop their last holder."""
        assert int(self.ref[pid]) > 0, \
            f"share_block: page {pid} is on the free list"
        self.tables[slot, block] = pid
        self.ref[pid] += 1

    def new_block(self, slot: int, block: int) -> int:
        """A fresh private page for ``block`` of ``slot``."""
        pid = self.alloc_page()
        self.tables[slot, block] = pid
        return pid

    def blocks_of(self, slot: int) -> list[int]:
        return [int(p) for p in self.tables[slot] if p != self.trash_page]

    def writable(self, slot: int, block: int) -> bool:
        """True iff ``block``'s page is private to ``slot`` (ref 1)."""
        pid = int(self.tables[slot, block])
        return pid != self.trash_page and int(self.ref[pid]) == 1

    def release_slot_pages(self, slot: int) -> None:
        """Drop every page reference ``slot`` holds and reset its row."""
        for block in range(self.max_blocks):
            pid = int(self.tables[slot, block])
            if pid != self.trash_page:
                self.ref_dec(pid)
        self.tables[slot] = self.trash_page

    def table_operand(self, slot: int, nb: int) -> np.ndarray:
        """The (nb+1,) table row a dispatch reads: the first ``nb``
        entries, then the trash page as the padded-write sink."""
        out = np.empty(nb + 1, np.int32)
        out[:nb] = self.tables[slot, :nb]
        out[nb] = self.trash_page
        return out

    def trash_operand(self, nb: int) -> np.ndarray:
        return np.full(nb + 1, self.trash_page, np.int32)

    def partition(self, index: int) -> "PagedKVCache":
        """Fresh bookkeeping over partition ``index`` of this cache's
        arena (no device memory is allocated)."""
        return PagedKVCache(self.specs, self.max_slots, self.page_tokens,
                            self.max_blocks, self.pool_pages,
                            n_caches=self.n_caches, index=index, arena=self)

    def dev_pages(self, ids) -> np.ndarray:
        """Page ids of this cache (the trash page included) as the
        arena's."""
        ids = np.asarray(ids, np.int32)
        return np.where(ids == self.trash_page, self.dev_trash_page,
                        ids + self.page_base).astype(np.int32)

    def dev_slots(self, slots) -> np.ndarray:
        """Slot ids of this cache (the scratch slot included) as the
        arena's."""
        slots = np.asarray(slots, np.int32)
        return np.where(slots == self.trash_slot, self.dev_trash_slot,
                        slots + self.slot_base).astype(np.int32)

    def nbytes(self) -> int:
        """This cache's share of the arena's device bytes."""
        return int(sum(a.numel() * a.element_size() for a in self.arrays)
                   // self.n_caches)


class _TrieNode:
    __slots__ = ("key", "page", "host", "children", "parent", "last_use")

    def __init__(self, key, page, parent) -> None:
        self.key = key          # the block's token ids (bytes)
        self.page = page        # its page id, or None while spilled
        self.host = None        # its host-tier frame, or None: a block
        #                         lives in exactly one tier
        self.children: dict = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Radix trie over block-aligned prompt prefixes (the reference's,
    copied).

    A key is the token ids of one full ``page_tokens`` block; a path
    root→node spells a block-aligned prefix with one page a block.  A
    match walks full blocks, then refines into the boundary block: the
    longest token-level common prefix with any child picks a
    copy-on-write donor.  A match is capped at ``len(prompt) - 1``
    tokens, as the first sampled token needs the last position's logits.
    Every node pins its page with one reference; :meth:`evict` unpins
    LRU leaves under pool pressure and :meth:`clear` drops everything (a
    weight swap makes every cached K/V stale).  With a host tier, a node
    may hold a host frame instead of a page (:meth:`spill_candidate`
    picks the block to demote); the node stays in the trie, so the block
    still matches."""

    def __init__(self, page_tokens: int) -> None:
        self.page_tokens = int(page_tokens)
        self.root = _TrieNode(None, None, None)
        self.nodes = 0
        self._clock = 0

    def _tick(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_use = self._clock

    @staticmethod
    def _key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int32).tobytes()

    def match_nodes(self, tokens: np.ndarray
                    ) -> tuple[list, int, tuple | None]:
        """The longest cached prefix of ``tokens`` (capped at ``n-1``):
        ``(full_block_nodes, matched_tokens, cow)``, ``cow`` being
        ``(donor_node, extra_tokens)`` for a partial boundary match
        (``matched_tokens`` includes ``extra_tokens``) or None.  Nodes,
        not page ids: a matched block may be spilled (``node.page`` is
        None), and the caller restores it before sharing."""
        n = int(tokens.shape[0])
        ptok = self.page_tokens
        node = self.root
        nodes: list[_TrieNode] = []
        matched = 0
        while matched + ptok <= n - 1:
            child = node.children.get(
                self._key(tokens[matched:matched + ptok]))
            if child is None:
                break
            node = child
            self._tick(node)
            nodes.append(node)
            matched += ptok
        tail = tokens[matched:min(n - 1, matched + ptok)]
        best, best_common = None, 0
        if len(tail) > 0:
            for child in node.children.values():
                key = np.frombuffer(child.key, np.int32)
                m = int(np.argmin(np.equal(
                    key[:len(tail)], tail).astype(np.int8))) \
                    if not np.array_equal(key[:len(tail)], tail) \
                    else len(tail)
                if m > best_common:
                    best, best_common = child, m
        if best is not None and best_common > 0:
            self._tick(best)
            return nodes, matched + best_common, (best, best_common)
        return nodes, matched, None

    def match(self, tokens: np.ndarray
              ) -> tuple[list[int], int, tuple | None]:
        """Page-id view of :meth:`match_nodes`."""
        nodes, matched, cow = self.match_nodes(tokens)
        return ([node.page for node in nodes], matched,
                None if cow is None else (cow[0].page, cow[1]))

    def insert(self, tokens: np.ndarray, table_row: np.ndarray,
               cache: PagedKVCache) -> int:
        """Register every full prompt block of ``tokens`` (pages from
        the sequence's ``table_row``); a new node pins its page.
        Returns the nodes added."""
        n = int(tokens.shape[0])
        ptok = self.page_tokens
        node = self.root
        added = 0
        for block in range(n // ptok):
            key = self._key(tokens[block * ptok:(block + 1) * ptok])
            child = node.children.get(key)
            if child is None:
                pid = int(table_row[block])
                if pid == cache.trash_page:
                    break  # not materialized
                child = _TrieNode(key, pid, node)
                node.children[key] = child
                cache.ref[pid] += 1  # the trie's pin
                self.nodes += 1
                added += 1
            node = child
            self._tick(node)
        return added

    def _leaves(self) -> list[_TrieNode]:
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root and not node.children:
                out.append(node)
            stack.extend(node.children.values())
        return out

    def spill_candidate(self, cache: PagedKVCache):
        """The least recently used block on a device page that nothing
        but the trie holds (``ref == 1``: no live sequence maps it), or
        None.  Safe to demote: the node stays in the trie, so a spill
        loses the block's residency but not its hit.  Interior nodes
        qualify too: a demotion orphans no child."""
        best = None
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.page is not None \
                    and int(cache.ref[node.page]) == 1 \
                    and (best is None or node.last_use < best.last_use):
                best = node
        return best

    def evict(self, cache: PagedKVCache, pages_needed: int) -> int:
        """Unpin LRU leaf blocks until ``pages_needed`` pages are free
        or no leaf on a device page is left (a spilled leaf holds no
        page, so dropping it would free nothing); an unpinned page frees
        at once when no live sequence holds it.  Returns the nodes
        evicted."""
        evicted = 0
        while cache.free_pages < pages_needed:
            leaves = [lf for lf in self._leaves() if lf.page is not None]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_use)
            victim.parent.children.pop(victim.key)
            cache.ref_dec(victim.page)
            self.nodes -= 1
            evicted += 1
        return evicted

    def spilled_nodes(self) -> int:
        """Blocks resident in the host tier."""
        count, stack = 0, list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.host is not None:
                count += 1
        return count

    def clear(self, cache: PagedKVCache, tier=None) -> int:
        """Drop the whole trie (a weight swap: the cached K/V are
        functions of the old weights) over both tiers, a spilled block's
        frame freed through ``tier``.  Returns the nodes dropped."""
        dropped = 0
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.page is not None:
                cache.ref_dec(node.page)
            elif tier is not None and node.host is not None:
                tier.free(node.host)
            dropped += 1
        self.root.children.clear()
        self.nodes = 0
        return dropped


class _Program:
    """One program: its key, its registry site, its int32 input buffer
    and the named views of it the body reads, the body, and on the card
    its graph, the graph's output and the addresses it was captured
    over."""

    __slots__ = ("key", "site", "layout", "buf", "views", "body", "graph",
                 "out", "fixed")

    def __init__(self, key, site: str, layout: list, device) -> None:
        self.key = key
        self.site = site
        #: (name, shape, value the warm-up fills in) a view
        self.layout = layout
        size = sum(int(np.prod(shape)) for _n, shape, _f in layout)
        self.buf = torch.zeros(max(1, size), dtype=torch.int32,
                               device=device)
        self.views: dict[str, torch.Tensor] = {}
        at = 0
        for name, shape, _fill in layout:
            n = int(np.prod(shape))
            self.views[name] = self.buf[at:at + n].view(shape)
            at += n
        self.body = None
        self.graph = None
        self.out = None
        self.fixed: list = []

    def host(self, **values) -> np.ndarray:
        """The buffer's host image: each view's values (its warm-up fill
        for a name not given)."""
        parts = [np.broadcast_to(np.asarray(values.get(name, fill),
                                            np.int32), shape).reshape(-1)
                 for name, shape, fill in self.layout]
        return np.concatenate(parts) if parts else np.zeros(1, np.int32)


class DecodeModel(Logger):
    """The prefill/decode program families and the KV cache over an
    exported LM.

    ``model`` is a :class:`~znicz_tpu_torch.export.ExportedModel` or a
    bundle path (loaded on ``device``: the card unless the caller asks
    for ``"cpu"``); its manifest must describe a causal LM.

    Geometry: ``max_slots`` concurrent sequences; ``max_t`` the longest
    sequence, rounded up to a power of two (a sequence reaching it is
    force-finished); ``max_prompt`` and ``prompt_align`` the prompt
    ladder (programs for ``prompt_align·2^k ≤ max_prompt``).

    Paged knobs (each default read from the manifest's ``decode``
    section, then ``root.common.engine``): ``paged`` (``paged_kv``,
    default on; off is the flat A/B arm, greedy token-identical),
    ``page_tokens`` (``kv_page_tokens``, 16), ``pool_tokens`` (default
    ``max_slots · max_t``, the flat cache's budget), ``spec_k`` (the
    verify family for ``spec_k``-token drafts, 0 off).  ``kv_quant``
    (``engine.kv_quant``, paged only): int8 pages with one f32 scale a
    (token, head) row; ``kv_dtype`` the pools' dtype otherwise (f32).
    An int8 bundle's weights stay int8 on the device as ``(q, scale)``
    pairs, dequantized in every body.

    ``n_caches`` (paged only) plans that many caches beside the model's
    own for :meth:`make_cache`, the private caches of a disaggregated
    engine's pool replicas: with :attr:`cache` they are partitions of
    one arena, so the programs warmed once serve all of them, and a
    replica made or repaired within the bound captures nothing."""

    def __init__(self, model, *, max_slots: int = 4, max_t: int = 64,
                 max_prompt: int | None = None, prompt_align: int = 8,
                 device=None, paged: bool | None = None,
                 page_tokens: int | None = None,
                 pool_tokens: int | None = None, spec_k: int = 0,
                 kv_quant: bool | None = None, kv_dtype=None,
                 n_caches: int = 0) -> None:
        super().__init__()
        from znicz_tpu_torch.export import ExportedModel
        if isinstance(model, (str, bytes)) or hasattr(model, "__fspath__"):
            model = ExportedModel.load(model, device=device)
        self.model = model
        decode_meta = model.decode_meta
        if paged is None:
            paged = bool(root.common.engine.get("paged_kv", True))
        self.paged = bool(paged)
        if page_tokens is None:
            page_tokens = int(decode_meta.get(
                "kv_page_tokens",
                root.common.engine.get("kv_page_tokens", 16)))
        if kv_quant is None:
            kv_quant = bool(decode_meta.get(
                "kv_quant", root.common.engine.get("kv_quant", False)))
        self.kv_quant = bool(kv_quant) and self.paged
        self.kv_dtype = np.dtype(kv_dtype if kv_dtype is not None
                                 else np.float32)
        self.spec_k = int(spec_k)
        if model.kind != "lm":
            raise ValueError(
                f"bundle '{model.manifest.get('workflow', '?')}' is a "
                f"'{model.kind}' — decode needs an LM (token-first causal "
                f"chain); re-export a generation model or use "
                f"ServingEngine for one-shot scoring")
        self.seq_meta = dict(model.sequence)
        self.vocab = int(self.seq_meta["vocab"])
        self.dim = int(self.seq_meta["dim"])
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_t = next_pow2(int(max_t))
        self.prompt_align = int(prompt_align)
        self.max_prompt = int(max_prompt if max_prompt is not None
                              else min(self.max_t // 2,
                                       bucket_for(self.seq_meta["train_t"],
                                                  self.prompt_align)))
        if self.max_prompt >= self.max_t:
            raise ValueError(
                f"max_prompt ({self.max_prompt}) must leave room to "
                f"generate below max_t ({self.max_t})")
        if bucket_for(self.max_prompt, self.prompt_align) > self.max_t:
            raise ValueError(
                f"prompt ladder top "
                f"{bucket_for(self.max_prompt, self.prompt_align)} "
                f"(max_prompt {self.max_prompt} rounded up to the "
                f"prompt_align·2^k ladder) exceeds the max_t {self.max_t} "
                f"cache page — raise max_t or lower max_prompt")
        self.device = model.device
        self._plan, cache_specs = self._build_plan()
        self.has_lstm = any(kind == "lstm" for _n, kind, _s in cache_specs)
        self.n_caches = int(n_caches)
        if self.n_caches and not self.paged:
            raise ValueError("pool replication (n_caches > 0) needs the "
                             "paged cache: a flat cache is bound to one "
                             "engine's slots")
        if self.paged:
            self.page_tokens = next_pow2(min(int(page_tokens), self.max_t))
            self.max_blocks = self.max_t // self.page_tokens
            if pool_tokens is None:
                pool_tokens = int(decode_meta.get(
                    "pool_tokens", self.max_slots * self.max_t))
            pool_pages = max(1, int(pool_tokens) // self.page_tokens)
            self.pool_tokens = pool_pages * self.page_tokens
            specs = []
            for name, kind, shape in cache_specs:
                if kind == "attention":
                    specs.append((name, "page", (shape[-2], shape[-1]),
                                  np.int8 if self.kv_quant
                                  else self.kv_dtype))
                else:
                    specs.append((name, "slot", shape, np.float32))
            if self.kv_quant:
                # the f32 scale pools come after every data spec, so the
                # plan's indices stay valid; as "page" kinds they share
                # the page ids, copies and trash of their int8 rows
                for op in self._plan:
                    if op.kind != "attention":
                        continue
                    for side in ("k", "v"):
                        name, _k, shape = cache_specs[op.aux[side]]
                        op.aux[f"{side}_scale"] = len(specs)
                        specs.append((f"{name}_scale", "page",
                                      (shape[-2],), np.float32))
            self.cache = PagedKVCache(specs, self.max_slots,
                                      self.page_tokens, self.max_blocks,
                                      pool_pages, device=self.device,
                                      n_caches=1 + self.n_caches)
        else:
            self.page_tokens = self.max_t
            self.max_blocks = 1
            self.pool_tokens = self.max_slots * self.max_t
            self.cache = KVCache(
                [(name, shape) for name, _kind, shape in cache_specs],
                self.max_slots, device=self.device)
        if self.spec_k and (not self.paged or self.has_lstm):
            raise ValueError(
                "speculative decoding needs the paged cache and an "
                "attention-only sequence phase (LSTM carries cannot roll "
                "back a rejected draft)")
        #: the arena's partitions :meth:`make_cache` may hand out
        self._free_caches = list(range(self.n_caches, 0, -1))
        #: the tensors ``page_in`` and ``carry_in`` read: one page a page
        #: pool, one row a carry array, written by a PageStager's
        #: uploader (or by a copy in :meth:`page_in`)
        self.page_stage: list = []
        self.carry_stage: list = []
        if self.paged:
            cache = self.cache
            self.page_stage = [torch.zeros(a.shape[1:], dtype=a.dtype,
                                           device=self.device)
                               for a in (cache.arrays[i]
                                         for i in cache.pool_indices)]
            self.carry_stage = [torch.zeros(a.shape[1:], dtype=a.dtype,
                                            device=self.device)
                                for a in (cache.arrays[i]
                                          for i in cache.slot_indices)]
        #: every dispatch (inputs, replay, the copy of its output) holds
        #: it: the graphs share one memory pool and each program one
        #: input buffer, and a disaggregated engine's pools dispatch from
        #: several threads
        self.dispatch_lock = threading.RLock()
        #: family → key → program
        self._programs: dict[str, dict] = {
            f: {} for f in ("prefill", "decode", "paged-prefill",
                            "paged-decode", "window", "copy", "page-in",
                            "carry-in")}
        #: programs made resident (on the card: captured)
        self.compile_count = 0
        #: a failed dispatch leaves the card's caches half written: only
        #: the CPU's retries run against untouched state
        self.donating = self.device.type == "cuda"
        self._pool = None
        #: the stream the programs warm up and are captured on
        self._side = None
        self._gc_depth = 0
        self._gc_was_on = True
        #: the weights every body reads: one tuple a plan op of f32
        #: tensors, ``(q, scale)`` pairs and None for absent leaves; a
        #: swap copies into them
        self._weights = self._gather_weights(self.model._params)
        self.weights_version = 0

    @property
    def graphed(self) -> bool:
        """True when a dispatch replays its program's CUDA graph: on the
        card."""
        return self.device.type == "cuda"

    # ------------------------------------------------------------------
    # chain planning
    # ------------------------------------------------------------------
    def _gather_weights(self, params: dict) -> tuple:
        """The weights from a bundle's host arrays, on the device: f32,
        or ``(int8 q, f32 scale)`` for a key of the bundle's ``quant``
        record."""
        qkeys = getattr(self.model, "_qkeys", frozenset())
        dev = self.device
        out = []
        for op in self._plan:
            leaves = []
            for key in op.wkeys:
                if key not in params:
                    leaves.append(None)
                elif key in qkeys:
                    leaves.append((
                        torch.as_tensor(np.asarray(params[key], np.int8),
                                        device=dev).clone(),
                        torch.as_tensor(np.asarray(
                            params[_quantize.scale_key(key)], np.float32),
                            device=dev).clone()))
                else:
                    leaves.append(torch.as_tensor(
                        np.asarray(params[key], np.float32),
                        device=dev).clone())
            out.append(tuple(leaves))
        return tuple(out)

    def _build_plan(self) -> tuple[list[_Op], list]:
        """The manifest's layers as decode ops and cache specs.

        Grammar: a sequence phase (embedding first, then pos_encoding,
        causal attention, LSTM), a bridge to per-sample features
        (``last_token``, or a final ``return_sequence=False`` LSTM),
        then head layers ending in the vocabulary softmax."""
        units = self.model.forwards
        layers = self.model.manifest["layers"]
        plan: list[_Op] = []
        cache_specs: list[tuple] = []
        phase = "seq"
        d = self.dim
        if not layers or layers[0]["type"] != "embedding":
            raise ValueError("decode chain must start with an embedding "
                             "layer (token-first)")
        for i, (spec, unit) in enumerate(zip(layers, units)):
            kind = spec["type"]
            if phase == "head" and kind not in _HEAD_KINDS:
                raise ValueError(
                    f"layer {i} ({kind}) after the sequence→sample bridge "
                    f"— only head layers {_HEAD_KINDS} may follow")
            if kind == "embedding":
                plan.append(_Op(kind, unit, (f"layer{i}_weights",)))
            elif kind == "pos_encoding":
                # 2·max_t rows: a tail prefill's window starts anywhere
                # below max_prompt, and rows past max_t feed only padded
                # positions
                table = torch.from_numpy(
                    unit.table_to(2 * self.max_t, d)).float().to(
                        self.device)
                plan.append(_Op(kind, unit, table=table))
            elif kind == "attention":
                if not spec.get("config", {}).get("causal"):
                    raise ValueError(
                        f"layer {i}: attention must be causal=True to "
                        f"decode (a bidirectional layer has no valid "
                        f"incremental step)")
                heads = unit.n_heads
                dh = d // heads
                k_idx = len(cache_specs)
                cache_specs.append((f"l{i}.k", "attention",
                                    (self.max_t, heads, dh)))
                cache_specs.append((f"l{i}.v", "attention",
                                    (self.max_t, heads, dh)))
                plan.append(_Op(kind, unit, (
                    f"layer{i}_weights", f"layer{i}_bias",
                    f"layer{i}_weights_out", f"layer{i}_bias_out"),
                    aux={"k": k_idx, "v": k_idx + 1}))
            elif kind == "lstm":
                h_idx = len(cache_specs)
                cache_specs.append((f"l{i}.h", "lstm", (unit.units,)))
                cache_specs.append((f"l{i}.c", "lstm", (unit.units,)))
                plan.append(_Op(kind, unit, (
                    f"layer{i}_weights", f"layer{i}_bias"),
                    aux={"h": h_idx, "c": h_idx + 1}))
                d = unit.units
                if not unit.return_sequence:
                    phase = "head"  # the carry is the sample bridge
            elif kind == "last_token":
                plan.append(_Op(kind, unit))
                phase = "head"
            elif kind in _HEAD_KINDS:
                if phase != "head":
                    raise ValueError(
                        f"layer {i} ({kind}) inside the sequence phase — "
                        f"FC layers flatten the time axis and cannot "
                        f"decode; bridge with last_token first")
                plan.append(_Op(kind, unit, (
                    f"layer{i}_weights", f"layer{i}_bias")))
            else:
                raise ValueError(
                    f"layer {i} ({kind}): no incremental decode step "
                    f"(supported: {_SEQ_KINDS + _HEAD_KINDS} + "
                    f"last_token)")
        if phase != "head":
            raise ValueError("chain never bridges to per-sample features "
                             "(last_token or a final "
                             "return_sequence=False LSTM)")
        if layers[-1]["type"] != "softmax":
            raise ValueError("decode chain must end in the softmax "
                             "vocabulary head")
        if not cache_specs:
            raise ValueError("stateless chain — nothing to cache, nothing "
                             "to decode")
        return plan, cache_specs

    # ------------------------------------------------------------------
    # bodies: each reads its program's views, the caches and the weights,
    # writes the caches in place and returns its logits
    # ------------------------------------------------------------------
    def _head(self, op: _Op, w, x, final: bool):
        """One head layer on (B, D) features; the final softmax gives
        raw logits (greedy is its argmax; sampling normalizes on the
        host)."""
        weights, b = w
        return op.unit.head(x, weights, b, final=final)

    @staticmethod
    def _in_place(caches: list, index: int, out: torch.Tensor) -> None:
        """An op must hand back the cache array it was given, written in
        place: a rebound result would leave a captured graph writing a
        copy the next dispatch never reads."""
        if out is not caches[index]:
            raise RuntimeError(
                f"cache array {index} was rebound by its update instead "
                f"of written in place (index_put_)")

    def _attend_paged(self, op: _Op, caches: list, feat, w, *args):
        """A paged attention entry point (``args`` after its pools),
        with the int8 scale pools when the cache has them; the pools are
        checked to be written in place."""
        ks = op.aux.get("k_scale")
        k, v = op.aux["k"], op.aux["v"]
        scales = {} if ks is None else {
            "k_scale": caches[ks], "v_scale": caches[op.aux["v_scale"]]}
        fn = args[0]
        out = fn(feat, caches[k], caches[v], *args[1:], *w, **scales)
        self._in_place(caches, k, out[1])
        self._in_place(caches, v, out[2])
        if ks is not None:
            self._in_place(caches, ks, out[3])
            self._in_place(caches, op.aux["v_scale"], out[4])
        return out[0]

    def _lstm_prefill(self, op: _Op, caches: list, feat, w, slot, length):
        feat, h, c = op.unit.prefill(feat, *w, length=length)
        caches[op.aux["h"]].index_put_((slot.long(),), h)
        caches[op.aux["c"]].index_put_((slot.long(),), c)
        return feat

    def _lstm_step(self, op: _Op, caches: list, feat, w, slots):
        idx = slots.long()
        h = caches[op.aux["h"]][idx]
        c = caches[op.aux["c"]][idx]
        feat, h, c = op.unit.decode_step(feat, h, c, *w)
        caches[op.aux["h"]].index_put_((idx,), h)
        caches[op.aux["c"]].index_put_((idx,), c)
        return feat[:, None, :] if op.unit.return_sequence else feat

    @staticmethod
    def _last_real(feat, length, t_bucket: int):
        """The last real position's features (not the padded tail's): a
        gather at ``length - 1``, clamped as the reference's dynamic
        index clamps."""
        idx = (length.long() - 1).clamp(0, t_bucket - 1)
        return feat.index_select(1, idx)[:, 0]

    def _prefill_body(self, prog: _Program, t_bucket: int):
        plan = self._plan
        v = prog.views

        def body():
            caches = self.cache.arrays
            tokens, slot, length = v["tokens"], v["slot"], v["length"]
            feat = logits = None
            for j, op in enumerate(plan):
                w = _dq_leaves(self._weights[j])
                if op.kind == "embedding":
                    feat = op.unit.embed(w[0], tokens)
                elif op.kind == "pos_encoding":
                    feat = feat.float() + op.table[:t_bucket][None]
                elif op.kind == "attention":
                    feat, k, vv = op.unit.prefill(feat, *w)
                    rows = slot.long().expand(t_bucket)
                    cols = torch.arange(t_bucket, device=feat.device)
                    caches[op.aux["k"]].index_put_((rows, cols), k[0])
                    caches[op.aux["v"]].index_put_((rows, cols), vv[0])
                elif op.kind == "lstm":
                    feat = self._lstm_prefill(op, caches, feat, w, slot,
                                              length)
                elif op.kind == "last_token":
                    feat = self._last_real(feat, length, t_bucket)
                else:
                    logits = feat = self._head(op, w, feat, op is plan[-1])
            return logits
        return body

    def _decode_body(self, prog: _Program, b_bucket: int):
        plan = self._plan
        v = prog.views

        def body():
            caches = self.cache.arrays
            tokens, slots, positions = v["tokens"], v["slots"], v["positions"]
            rows = torch.arange(b_bucket, device=tokens.device)
            feat = logits = None
            for j, op in enumerate(plan):
                w = _dq_leaves(self._weights[j])
                if op.kind == "embedding":
                    feat = op.unit.embed(w[0], tokens)[:, None, :]
                elif op.kind == "pos_encoding":
                    feat = op.unit.decode_step(feat, positions, op.table)
                elif op.kind == "attention":
                    idx, pos = slots.long(), positions.long()
                    k_rows = caches[op.aux["k"]][idx]
                    v_rows = caches[op.aux["v"]][idx]
                    feat, k_rows, v_rows = op.unit.decode_step(
                        feat, k_rows, v_rows, positions, *w)
                    # only row `pos` changed a lane; padded lanes land in
                    # the scratch slot (their duplicate writes there are
                    # garbage by design)
                    caches[op.aux["k"]].index_put_((idx, pos),
                                                   k_rows[rows, pos])
                    caches[op.aux["v"]].index_put_((idx, pos),
                                                   v_rows[rows, pos])
                elif op.kind == "lstm":
                    feat = self._lstm_step(op, caches, feat, w, slots)
                elif op.kind == "last_token":
                    feat = feat[:, 0]
                else:
                    if feat.dim() == 3:  # head after a seq-phase bridge
                        feat = feat[:, 0]
                    logits = feat = self._head(op, w, feat, op is plan[-1])
            return logits
        return body

    def _paged_prefill_body(self, prog: _Program, t_bucket: int):
        plan = self._plan
        v = prog.views

        def body():
            caches = self.cache.arrays
            tokens, table = v["tokens"], v["table"]
            slot, start, length = v["slot"], v["start"], v["length"]
            feat = logits = None
            for j, op in enumerate(plan):
                w = _dq_leaves(self._weights[j])
                if op.kind == "embedding":
                    feat = op.unit.embed(w[0], tokens)
                elif op.kind == "pos_encoding":
                    rows = (start.long() + torch.arange(
                        t_bucket, device=start.device)).clamp(
                            max=op.table.shape[0] - 1)
                    feat = feat.float() + op.table[rows][None]
                elif op.kind == "attention":
                    feat = self._attend_paged(
                        op, caches, feat, w, op.unit.prefill_paged, table,
                        start[0], length[0])
                elif op.kind == "lstm":
                    # an LSTM chain never shares a prefix (start is 0):
                    # the carry is the whole prefix's state
                    feat = self._lstm_prefill(op, caches, feat, w, slot,
                                              length)
                elif op.kind == "last_token":
                    feat = self._last_real(feat, length, t_bucket)
                else:
                    logits = feat = self._head(op, w, feat, op is plan[-1])
            return logits
        return body

    def _paged_decode_body(self, prog: _Program):
        plan = self._plan
        v = prog.views

        def body():
            caches = self.cache.arrays
            tokens, tables = v["tokens"], v["tables"]
            slots, positions = v["slots"], v["positions"]
            feat = logits = None
            for j, op in enumerate(plan):
                w = _dq_leaves(self._weights[j])
                if op.kind == "embedding":
                    feat = op.unit.embed(w[0], tokens)[:, None, :]
                elif op.kind == "pos_encoding":
                    feat = op.unit.decode_step(feat, positions, op.table)
                elif op.kind == "attention":
                    feat = self._attend_paged(
                        op, caches, feat, w, op.unit.decode_step_paged,
                        tables, positions)
                elif op.kind == "lstm":
                    feat = self._lstm_step(op, caches, feat, w, slots)
                elif op.kind == "last_token":
                    feat = feat[:, 0]
                else:
                    if feat.dim() == 3:
                        feat = feat[:, 0]
                    logits = feat = self._head(op, w, feat, op is plan[-1])
            return logits
        return body

    def _window_body(self, prog: _Program, b_bucket: int, w_len: int):
        plan = self._plan
        v = prog.views

        def body():
            caches = self.cache.arrays
            tokens, tables = v["tokens"], v["tables"]
            positions, lengths = v["positions"], v["lengths"]
            feat = logits = None
            for j, op in enumerate(plan):
                w = _dq_leaves(self._weights[j])
                if op.kind == "embedding":
                    feat = op.unit.embed(w[0], tokens)
                elif op.kind == "pos_encoding":
                    rows = (positions.long()[:, None] + torch.arange(
                        w_len, device=tokens.device)[None]).clamp(
                            max=op.table.shape[0] - 1)
                    feat = feat.float() + op.table[rows]
                elif op.kind == "attention":
                    feat = self._attend_paged(
                        op, caches, feat, w, op.unit.window_paged, tables,
                        positions, lengths)
                elif op.kind == "last_token":
                    # every window position reaches the head: the window
                    # folds into the batch
                    feat = feat.reshape(b_bucket * w_len, -1)
                else:
                    logits = feat = self._head(op, w, feat, op is plan[-1])
            return logits.reshape(b_bucket, w_len, -1)
        return body

    def _copy_body(self, prog: _Program):
        pool_indices = self.cache.pool_indices
        v = prog.views

        def body():
            caches = self.cache.arrays
            src, dst = v["src"].long(), v["dst"].long()
            for i in pool_indices:
                caches[i].index_copy_(0, dst, caches[i].index_select(0, src))
            return None
        return body

    def _page_in_body(self, prog: _Program):
        pool_indices = self.cache.pool_indices
        stage = self.page_stage
        v = prog.views

        def body():
            caches = self.cache.arrays
            dst = v["dst"].long()
            for j, i in enumerate(pool_indices):
                caches[i].index_copy_(0, dst, stage[j][None])
            return None
        return body

    def _carry_in_body(self, prog: _Program):
        slot_indices = self.cache.slot_indices
        stage = self.carry_stage
        v = prog.views

        def body():
            caches = self.cache.arrays
            slot = v["slot"].long()
            for j, i in enumerate(slot_indices):
                caches[i].index_copy_(0, slot, stage[j][None])
            return None
        return body

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    def _bound(self) -> list[tuple[str, torch.Tensor]]:
        """Every tensor a program reads besides its inputs: the cache
        arrays, the staging tensors, the weights (an int8 key's q and
        scales) and the encoding tables."""
        out = [(f"cache array '{spec[0]}'", a)
               for spec, a in zip(self.cache.specs, self.cache.arrays)]
        out += [(f"page staging tensor {j}", t)
                for j, t in enumerate(self.page_stage)]
        out += [(f"carry staging tensor {j}", t)
                for j, t in enumerate(self.carry_stage)]
        for op, ws in zip(self._plan, self._weights):
            for key, leaf in zip(op.wkeys, ws):
                if isinstance(leaf, tuple):
                    out += [(f"weight {key}", leaf[0]),
                            (f"weight {_quantize.scale_key(key)}", leaf[1])]
                elif leaf is not None:
                    out.append((f"weight {key}", leaf))
            if op.table is not None:
                out.append((f"{op.kind} table", op.table))
        return out

    def _graph_pool(self):
        """The memory pool every program of this model shares."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @contextlib.contextmanager
    def _collector_off(self):
        """The garbage collector off (a graph it destroyed mid-capture
        would invalidate the capture), after one collection, for a
        capture or a whole warm-up's worth of them."""
        if self._gc_depth == 0:
            gc.collect()
            self._gc_was_on = gc.isenabled()
            gc.disable()
        self._gc_depth += 1
        try:
            yield
        finally:
            self._gc_depth -= 1
            if self._gc_depth == 0 and self._gc_was_on:
                gc.enable()

    def _program(self, family: str, key, site: str, layout: list, make):
        """The program of ``family`` at ``key``, made resident on first
        use: its input buffer filled with the warm-up values (every write
        of theirs lands in the scratch slot or the trash page), its body,
        and on the card its graph."""
        progs = self._programs[family]
        prog = progs.get(key)
        if prog is None:
            prog = _Program(key, site, layout, self.device)
            prog.body = make(prog)
            prog.buf.copy_(torch.from_numpy(prog.host()))
            if self.graphed:
                with self._collector_off():
                    self._capture(prog, family)
            progs[key] = prog
            self.compile_count += 1
        return prog

    def _capture(self, prog: _Program, family: str) -> None:
        """The body run eagerly on the model's side stream (its warm-up),
        then captured there into the program's graph in thread-local mode
        (another thread staging a swap meanwhile is no part of it).  The
        capture is begun and ended directly: ``torch.cuda.graph`` would
        synchronize the device and empty the allocator's cache for each of
        a grid's programs."""
        dev = self.device
        name = self.model.manifest.get("workflow", "model")
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        side = self._side
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.no_grad():
            prog.body()
            try:
                with _tracing.TRACER.span(f"capture:{name}:{prog.site}",
                                          cat="capture"):
                    graph.capture_begin(pool=self._graph_pool(),
                                        capture_error_mode="thread_local")
                    try:
                        out = prog.body()
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
            except Exception as exc:
                raise RuntimeError(
                    f"'{name}': the CUDA-graph capture of the {family} "
                    f"program {prog.key} failed: {exc}") from exc
        torch.cuda.current_stream(dev).wait_stream(side)
        prog.graph, prog.out = graph, out
        prog.fixed = [(what, t.data_ptr()) for what, t in self._bound()]
        _metrics.graph_captures(prog.site).inc()

    def _replay(self, prog: _Program):
        for (what, ptr), (_, tensor) in zip(prog.fixed, self._bound()):
            if tensor.data_ptr() != ptr:
                raise RuntimeError(
                    f"program {prog.key} ({prog.site}): {what} was rebound "
                    f"after the capture, whose graph reads the tensor it "
                    f"held then; write it in place instead")
        prog.graph.replay()
        return prog.out

    def _run(self, prog: _Program, **values):
        """One dispatch: the inputs into the program's buffer (one
        copy), then its graph replayed (the card) or its body run."""
        prog.buf.copy_(torch.from_numpy(prog.host(**values)))
        if self.graphed:
            return self._replay(prog)
        with torch.no_grad():
            return prog.body()

    def _logits(self, out, n: int | None = None) -> np.ndarray:
        """The caller's own f32 host copy of a dispatch's logits.  Always
        a copy: a replay's output is the program's buffer, which another
        thread's next dispatch overwrites once the dispatch lock is
        released (C19: on the CPU ``.cpu()`` returns that buffer
        itself)."""
        out = out if n is None else out[:n]
        return out.detach().to("cpu", torch.float32, copy=True).numpy()

    def prefill_program(self, t_bucket: int) -> _Program:
        trash = self.cache.trash_slot
        return self._program(
            "prefill", t_bucket, "serving-prefill",
            [("tokens", (1, t_bucket), 0), ("slot", (1,), trash),
             ("length", (1,), 1)],
            lambda p: self._prefill_body(p, t_bucket))

    def decode_program(self, b_bucket: int) -> _Program:
        trash = self.cache.trash_slot
        return self._program(
            "decode", b_bucket, "serving-decode",
            [("tokens", (b_bucket,), 0), ("slots", (b_bucket,), trash),
             ("positions", (b_bucket,), 0)],
            lambda p: self._decode_body(p, b_bucket))

    def paged_prefill_program(self, t_bucket: int, nb: int) -> _Program:
        cache = self.cache
        return self._program(
            "paged-prefill", (t_bucket, nb), "serving-prefill",
            [("tokens", (1, t_bucket), 0),
             ("table", (nb + 1,), cache.dev_trash_page),
             ("slot", (1,), cache.dev_trash_slot), ("start", (1,), 0),
             ("length", (1,), 1)],
            lambda p: self._paged_prefill_body(p, t_bucket))

    def paged_decode_program(self, b_bucket: int, nb: int) -> _Program:
        cache = self.cache
        return self._program(
            "paged-decode", (b_bucket, nb), "serving-decode",
            [("tokens", (b_bucket,), 0),
             ("tables", (b_bucket, nb + 1), cache.dev_trash_page),
             ("slots", (b_bucket,), cache.dev_trash_slot),
             ("positions", (b_bucket,), 0)],
            self._paged_decode_body)

    def window_program(self, b_bucket: int, w_len: int, nb: int,
                       site: str = "serving-verify") -> _Program:
        cache = self.cache
        return self._program(
            "window", (b_bucket, w_len, nb), site,
            [("tokens", (b_bucket, w_len), 0),
             ("tables", (b_bucket, nb + 1), cache.dev_trash_page),
             ("positions", (b_bucket,), 0), ("lengths", (b_bucket,), 0)],
            lambda p: self._window_body(p, b_bucket, w_len))

    def verify_program(self, b_bucket: int, nb: int) -> _Program:
        if not self.spec_k:
            raise RuntimeError("spec_k=0 — no verify family planned")
        return self.window_program(b_bucket, self.spec_k + 1, nb)

    def copy_program(self) -> _Program:
        trash = self.cache.dev_trash_page
        return self._program(
            "copy", "copy", "serving-page",
            [("src", (1,), trash), ("dst", (1,), trash)], self._copy_body)

    def page_in_program(self) -> _Program:
        if not (self.paged and self.cache.pool_indices):
            raise RuntimeError("page_in needs a paged cache with page "
                               "pools (an attention layer)")
        return self._program(
            "page-in", "page-in", "serving-page",
            [("dst", (1,), self.cache.dev_trash_page)], self._page_in_body)

    def carry_in_program(self) -> _Program:
        if not (self.paged and self.has_lstm):
            raise RuntimeError("carry_in needs a paged LSTM chain")
        return self._program(
            "carry-in", "carry-in", "serving-page",
            [("slot", (1,), self.cache.dev_trash_slot)],
            self._carry_in_body)

    def prompt_ladder(self) -> list[int]:
        return ladder(self.max_prompt, self.prompt_align)

    def batch_ladder(self) -> list[int]:
        return ladder(self.max_slots)

    def block_ladder(self) -> list[int]:
        """Power-of-two block-count buckets: a dispatch reads only
        ``nb·page_tokens`` cache rows a lane."""
        return ladder(self.max_blocks) if self.paged else [1]

    def nb_for(self, top_position: int) -> int:
        """The block bucket covering positions ``0..top_position``."""
        blocks = -(-(int(top_position) + 1) // self.page_tokens)
        return min(next_pow2(max(1, blocks)), self.max_blocks)

    def fresh_nb(self, t_bucket: int) -> int:
        return self.nb_for(t_bucket - 1)

    def warmup(self, prefix_cache: bool = True, page_io: bool = False) -> int:
        """Make every program of the grid resident (on the card:
        captured), so a decode loop at any live-batch size, block depth
        and prompt mix makes none.  ``prefix_cache=False`` leaves out the
        tail prefills (``start > 0``), the admission windows and the
        copy, which only prefix sharing dispatches.  ``page_io=True``
        adds ``page_in`` (a chain with page pools) and ``carry_in`` (an
        LSTM chain): spill restores and pool handoffs then make none
        either.  Returns the programs made resident."""
        before = self.compile_count
        with self._collector_off() if self.graphed \
                else contextlib.nullcontext():
            self._warm_grid(prefix_cache)
            if page_io and self.paged:
                if self.cache.pool_indices:
                    self.page_in_program()
                if self.has_lstm:
                    self.carry_in_program()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_count - before

    def _warm_grid(self, prefix_cache: bool) -> None:
        if not self.paged:
            for t_b in self.prompt_ladder():
                self.prefill_program(t_b)
            for b_b in self.batch_ladder():
                self.decode_program(b_b)
        else:
            for t_b in self.prompt_ladder():
                for nb in self.block_ladder():
                    if nb < self.fresh_nb(t_b):
                        continue  # a window never shrinks its own blocks
                    if nb > self.fresh_nb(t_b) and not prefix_cache:
                        continue  # start > 0 only follows a prefix hit
                    self.paged_prefill_program(t_b, nb)
            for b_b in self.batch_ladder():
                for nb in self.block_ladder():
                    self.paged_decode_program(b_b, nb)
                    if self.spec_k:
                        self.verify_program(b_b, nb)
                    if prefix_cache and not self.has_lstm:
                        # the admission-coalescing window: a wave of
                        # prefix-hit tails admits in one dispatch
                        self.window_program(b_b, self.prompt_align, nb,
                                            site="serving-prefill")
            if prefix_cache:
                self.copy_program()

    @property
    def programs_live(self) -> int:
        return sum(len(p) for p in self._programs.values())

    @property
    def captures(self) -> int:
        """Programs captured as CUDA graphs so far."""
        return sum(p.graph is not None for progs in self._programs.values()
                   for p in progs.values())

    # ------------------------------------------------------------------
    # the planned caches: partitions of the arena
    # ------------------------------------------------------------------
    def make_cache(self) -> PagedKVCache:
        """One of the ``n_caches`` caches planned beside :attr:`cache`:
        the same geometry, served by the same programs, so nothing is
        made resident or captured for it.  Raises past the bound."""
        if not self.paged:
            raise RuntimeError("pool replication needs the paged cache")
        with self.dispatch_lock:
            if not self._free_caches:
                raise RuntimeError(
                    f"every planned cache is in use: the model was built "
                    f"with n_caches={self.n_caches}, which bounds the pool "
                    f"replicas it serves")
            return self.cache.partition(self._free_caches.pop())

    def release_cache(self, cache: PagedKVCache) -> None:
        """Give back a cache :meth:`make_cache` handed out (its replica
        stopped).  A later :meth:`make_cache` hands out fresh bookkeeping
        over its partition; its stale pages are written before any
        sequence reads them, as a freed page's are."""
        with self.dispatch_lock:
            if cache.arrays is not self.cache.arrays or cache.index == 0 \
                    or cache.index in self._free_caches:
                raise ValueError(f"cache {cache.index} was not handed out "
                                 f"by this model's make_cache")
            self._free_caches.append(cache.index)

    @property
    def caches_free(self) -> int:
        return len(self._free_caches)

    # ------------------------------------------------------------------
    # dispatch (the engine's scheduler; a disaggregated engine's workers)
    # ------------------------------------------------------------------
    def run_prefill(self, tokens: np.ndarray, slot: int,
                    start: int = 0,
                    cache: PagedKVCache | None = None) -> np.ndarray:
        """Prefill one prompt window into ``slot`` of ``cache`` (the
        model's own by default): ``tokens`` are the positions
        ``start..start+len-1`` (the whole prompt at ``start=0``, the
        unshared tail after a prefix hit, paged only).  Returns the last
        real position's logits (V,)."""
        cache = self.cache if cache is None else cache
        n = int(tokens.shape[0])
        if start + n > self.max_prompt:
            raise ValueError(f"prompt of {start + n} tokens exceeds "
                             f"max_prompt {self.max_prompt}")
        t_b = bucket_for(n, self.prompt_align)
        padded = np.zeros((1, t_b), np.int32)
        padded[0, :n] = tokens
        with self.dispatch_lock:
            if not self.paged:
                if start:
                    raise ValueError("flat cache cannot tail-prefill")
                out = self._run(self.prefill_program(t_b), tokens=padded,
                                slot=slot, length=n)
                return self._logits(out)[0]
            nb = self.nb_for(start + t_b - 1)
            out = self._run(self.paged_prefill_program(t_b, nb),
                            tokens=padded,
                            table=cache.dev_pages(cache.table_operand(slot,
                                                                      nb)),
                            slot=cache.dev_slots(slot), start=start,
                            length=n)
            return self._logits(out)[0]

    def _check_positions(self, positions: np.ndarray) -> None:
        if len(positions) and (int(positions.min()) < 0
                               or int(positions.max()) >= self.max_t):
            raise ValueError(f"positions {positions.tolist()} outside "
                             f"[0, max_t={self.max_t})")

    def run_decode(self, tokens: np.ndarray, slots: np.ndarray,
                   positions: np.ndarray,
                   cache: PagedKVCache | None = None) -> np.ndarray:
        """One token step for ``len(tokens)`` lanes of ``cache``, padded
        to the covering batch bucket (padded lanes on the scratch slot or
        the trash table).  Returns logits (n, V)."""
        cache = self.cache if cache is None else cache
        n = int(tokens.shape[0])
        self._check_positions(positions)
        b_b = bucket_for(n)

        def padded(arr, fill):
            out = np.full((b_b,), fill, np.int32)
            out[:n] = arr
            return out

        with self.dispatch_lock:
            if not self.paged:
                out = self._run(self.decode_program(b_b),
                                tokens=padded(tokens, 0),
                                slots=padded(slots, cache.trash_slot),
                                positions=padded(positions, 0))
                return self._logits(out, n)
            nb = self.nb_for(int(positions.max()))
            tables = np.full((b_b, nb + 1), cache.trash_page, np.int32)
            tables[:n, :nb] = cache.tables[slots, :nb]
            out = self._run(
                self.paged_decode_program(b_b, nb),
                tokens=padded(tokens, 0), tables=cache.dev_pages(tables),
                slots=cache.dev_slots(padded(slots, cache.trash_slot)),
                positions=padded(positions, 0))
            return self._logits(out, n)

    def run_window(self, windows: np.ndarray, slots: np.ndarray,
                   positions: np.ndarray, lengths: np.ndarray,
                   site: str = "serving-verify",
                   cache: PagedKVCache | None = None) -> np.ndarray:
        """Token windows (n, W) starting at per-lane ``positions`` with
        ``lengths`` real tokens each, written and attended through the
        page tables in one forward.  Returns logits (n, W, V)."""
        cache = self.cache if cache is None else cache
        n, w_len = windows.shape
        self._check_positions(positions)
        b_b = bucket_for(n)
        nb = self.nb_for(int(positions.max()) + w_len - 1)
        win = np.zeros((b_b, w_len), np.int32)
        win[:n] = windows
        tables = np.full((b_b, nb + 1), cache.trash_page, np.int32)
        tables[:n, :nb] = cache.tables[slots, :nb]
        pos = np.zeros((b_b,), np.int32)
        pos[:n] = positions
        lens = np.zeros((b_b,), np.int32)
        lens[:n] = lengths
        with self.dispatch_lock:
            out = self._run(self.window_program(b_b, int(w_len), nb,
                                                site=site),
                            tokens=win, tables=cache.dev_pages(tables),
                            positions=pos, lengths=lens)
            return self._logits(out, n)

    def run_verify(self, windows: np.ndarray, slots: np.ndarray,
                   positions: np.ndarray,
                   cache: PagedKVCache | None = None) -> np.ndarray:
        """Speculative verification: (n, spec_k+1) windows at per-lane
        ``positions``; logits at every window position."""
        if not self.spec_k:
            raise RuntimeError("spec_k=0 — no verify family planned")
        lengths = np.full((windows.shape[0],), self.spec_k + 1, np.int32)
        return self.run_window(windows, slots, positions, lengths,
                               cache=cache)

    def copy_page(self, src: int, dst: int,
                  cache: PagedKVCache | None = None) -> None:
        """Copy one page across every pool: the copy on write a partial
        prefix match pays before its divergent tail."""
        cache = self.cache if cache is None else cache
        with self.dispatch_lock:
            self._run(self.copy_program(), src=cache.dev_pages(src),
                      dst=cache.dev_pages(dst))

    # ------------------------------------------------------------------
    # page and carry I/O: the data plane of spill restores and
    # prefill→decode handoffs
    # ------------------------------------------------------------------
    def page_shapes(self) -> list[tuple[tuple, np.dtype]]:
        """(shape, dtype) of one page of each page pool: the frame of the
        host tier and of a staging ring."""
        return [(tuple(t.shape), _np_dtype(t.dtype))
                for t in self.page_stage]

    def carry_shapes(self) -> list[tuple[tuple, np.dtype]]:
        """(shape, dtype) of one slot's carry rows (an LSTM chain)."""
        return [(tuple(t.shape), _np_dtype(t.dtype))
                for t in self.carry_stage]

    def _fetch(self, tensors: list) -> list[np.ndarray]:
        """Device tensors copied to page-locked host memory on the
        current stream and fenced (the caller frees or overwrites their
        pages next); on the CPU, the tensors themselves."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for out, t in zip(outs, tensors):
            out.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).record_event().synchronize()
        return [out.numpy() for out in outs]

    def export_pages(self, pids, cache: PagedKVCache | None = None
                     ) -> list[list[np.ndarray]]:
        """Pages ``pids`` of ``cache`` copied to the host: one page set
        (one (page_tokens, ...) array a page pool) a page, the unit the
        host tier stores and a handoff ships.  One gather and one fenced
        copy a pool for all of them."""
        cache = self.cache if cache is None else cache
        pids = [int(p) for p in pids]
        if not cache.pool_indices or not pids:
            return [[] for _ in pids]
        idx = torch.as_tensor(cache.dev_pages(pids), dtype=torch.long,
                              device=self.device)
        with self.dispatch_lock:
            host = self._fetch([cache.arrays[i].index_select(0, idx)
                                for i in cache.pool_indices])
        return [[h[b] for h in host] for b in range(len(pids))]

    def export_page(self, pid: int, cache: PagedKVCache | None = None
                    ) -> list[np.ndarray]:
        """Page ``pid`` of ``cache`` copied to the host (one array a page
        pool)."""
        return self.export_pages([pid], cache)[0]

    def page_in(self, pages, dst: int,
                cache: PagedKVCache | None = None) -> None:
        """Write one page set into page ``dst`` of ``cache``: ``pages``
        are :attr:`page_stage` as a :class:`~znicz_tpu_torch.memory.
        PageStager` filled them (the replay only, ordered after the
        upload by the stager's event), or host arrays or tensors, first
        copied into the staging tensors."""
        cache = self.cache if cache is None else cache
        if not cache.pool_indices:
            return  # a chain without page pools moves no page content
        with self.dispatch_lock:
            self._stage(pages, self.page_stage)
            self._run(self.page_in_program(), dst=cache.dev_pages(dst))

    def export_carry(self, slot: int, cache: PagedKVCache | None = None
                     ) -> list[np.ndarray]:
        """Slot ``slot``'s LSTM carry rows (h and c a layer) copied to
        the host: the slot-indexed half of a handoff."""
        cache = self.cache if cache is None else cache
        idx = int(cache.dev_slots(slot))
        with self.dispatch_lock:
            return self._fetch([cache.arrays[i][idx].clone()
                                for i in cache.slot_indices])

    def carry_in(self, rows, slot: int,
                 cache: PagedKVCache | None = None) -> None:
        """Write carry rows into slot ``slot`` of ``cache`` (as
        :meth:`page_in` writes a page)."""
        cache = self.cache if cache is None else cache
        with self.dispatch_lock:
            self._stage(rows, self.carry_stage)
            self._run(self.carry_in_program(), slot=cache.dev_slots(slot))

    @staticmethod
    def _stage(values, stage: list) -> None:
        if len(values) != len(stage):
            raise ValueError(f"{len(values)} arrays for {len(stage)} "
                             f"staging tensors")
        for t, value in zip(stage, values):
            if value is t:
                continue  # a stager's upload landed it there
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.ascontiguousarray(value))
            t.copy_(value)

    # ------------------------------------------------------------------
    # weight hot-swap
    # ------------------------------------------------------------------
    def check_compatible(self, manifest: dict | None, params: dict) -> None:
        """Validate a candidate against the planned chain; raises
        :class:`~znicz_tpu_torch.export.SwapIncompatible` with the
        incumbent untouched on any mismatch."""
        from znicz_tpu_torch.export import SwapIncompatible
        if manifest is not None:
            mine = [layer["type"] for layer in self.model.manifest["layers"]]
            theirs = [layer["type"] for layer in manifest.get("layers", [])]
            if mine != theirs:
                raise SwapIncompatible(
                    f"candidate layer table {theirs} != decode chain "
                    f"{mine}")
        for op, ws in zip(self._plan, self._weights):
            for key, cur in zip(op.wkeys, ws):
                new = params.get(key)
                if cur is None:
                    if new is not None:
                        raise SwapIncompatible(
                            f"{key}: candidate carries a parameter the "
                            f"programs have no operand for")
                    continue
                if new is None:
                    raise SwapIncompatible(
                        f"candidate is missing parameter '{key}'")
                shape = tuple((cur[0] if isinstance(cur, tuple)
                               else cur).shape)
                if tuple(np.shape(new)) != shape:
                    raise SwapIncompatible(
                        f"{key}: candidate shape {tuple(np.shape(new))} != "
                        f"compiled {shape}")

    def swap_weights(self, params: dict,
                     manifest: dict | None = None) -> int:
        """Replace the weights with no new program: validate, stage the
        candidate on the device, then copy it into the tensors the
        programs read, and wait for the copies.  The caller
        (:meth:`DecodeEngine.swap_weights`) makes sure no dispatch is in
        flight.  An int8 chain takes only an int8 candidate over the same
        keys; an int8 candidate into an f32 chain is dequantized on the
        host."""
        from znicz_tpu_torch.export import SwapIncompatible
        qkeys = getattr(self.model, "_qkeys", frozenset())
        cand_rec = _quantize.is_quantized(manifest)
        if qkeys:
            if cand_rec is None:
                raise SwapIncompatible(
                    "candidate is f32 but the decode chain runs int8 "
                    "dequantize-on-load programs — republish the "
                    "candidate with quantize='int8' (or restart the "
                    "replica f32)")
            if frozenset(cand_rec.get("weights", [])) != qkeys:
                raise SwapIncompatible(
                    "candidate quantizes a different key set than the "
                    f"programs ({sorted(cand_rec.get('weights', []))} != "
                    f"{sorted(qkeys)})")
        elif cand_rec is not None:
            params = _quantize.dequantize_params(manifest, params)
        self.check_compatible(manifest, params)
        dev = self.device
        staged, host = [], {}
        for op, ws in zip(self._plan, self._weights):
            for key, cur in zip(op.wkeys, ws):
                if cur is None:
                    continue
                if isinstance(cur, tuple):
                    skey = _quantize.scale_key(key)
                    q = np.ascontiguousarray(np.asarray(params[key], np.int8))
                    s = np.ascontiguousarray(np.asarray(params[skey],
                                                        np.float32))
                    staged += [(cur[0], torch.from_numpy(q).to(dev)),
                               (cur[1], torch.from_numpy(s).to(dev))]
                    host[key], host[skey] = q.copy(), s.copy()
                else:
                    new = np.ascontiguousarray(np.asarray(params[key],
                                                          np.float32))
                    staged.append((cur, torch.from_numpy(new).to(dev)))
                    host[key] = new.copy()
        with self.dispatch_lock, torch.no_grad():
            for cur, new in staged:
                cur.copy_(new)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.model._params.update(host)
        self.weights_version += 1
        return self.weights_version


class _PromptReq:
    """One queued generation request.

    ``pause_s`` accumulates the admission pause (swap drains) that
    overlapped its queue wait: TTFT and the TTFT deadline both stamp from
    admission-eligible time, ``t_submit + pause_s``."""

    __slots__ = ("tokens", "n", "max_new", "future", "t_submit",
                 "deadline", "pause_s", "charged", "tenant", "priority",
                 "trace")

    def __init__(self, tokens: np.ndarray, max_new: int,
                 deadline_ms: float | None, tenant: str | None = None,
                 priority: int = 0) -> None:
        self.tokens = tokens
        self.n = int(tokens.shape[0])
        self.max_new = int(max_new)
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.pause_s = 0.0
        self.charged = 0  # tokens held against the admission budget
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline = (None if deadline_ms is None
                         else self.t_submit + float(deadline_ms) / 1e3)
        # the request's trace, minted here (or adopted from a router that
        # stamped its decision on it) and carried queue → prefill → decode
        self.trace = (_tracing.adopt_pending_trace()
                      or _tracing.new_request_trace(
                          "request", tokens=self.n, tenant=tenant or "-"))
        self.trace.phase_begin("queue")

    def expired(self, now: float) -> bool:
        return self.deadline is not None \
            and now >= self.deadline + self.pause_s


class _Live:
    """Host-side state of one sequence mid-generation."""

    __slots__ = ("req", "slot", "pos", "generated", "t_last")

    def __init__(self, req: _PromptReq, slot: int, first_token: int) -> None:
        self.req = req
        self.slot = slot
        #: the position the next input token takes (the prompt length
        #: right after prefill; the sampled token is fed back there)
        self.pos = req.n
        self.generated = [int(first_token)]
        self.t_last = time.monotonic()


class _PageSetupMixin:
    """Paged admission, shared by :class:`DecodeEngine` and the
    disaggregated engine's prefill workers: prefix match → share, copy
    on write, allocate, with the spill tier's room-making.  The host has
    ``self.model`` (a :class:`DecodeModel`), ``self.prefix``
    (:class:`PrefixCache` or None), ``self._spill`` (a
    :class:`~znicz_tpu_torch.memory.HostPageTier` or None), ``self._obs_id``
    and the prefix and migration metric children; :meth:`_kv_cache` names
    the cache it schedules (a pool worker's private cache, the model's
    own otherwise)."""

    def _kv_cache(self) -> PagedKVCache:
        return self.model.cache

    def _setup_pages(self, slot: int, tokens: np.ndarray,
                     max_new: int) -> int:
        """Map the request's blocks into ``slot``'s table: shared full
        blocks by reference, a partly matched boundary block by a copy,
        fresh pages for the rest — reserving the whole worst-case span
        (prompt + token budget, capped at max_t) up front, so an admitted
        request is never starved of pages mid-generation.  Returns the
        matched token count (where the tail prefill starts).  Raises
        :class:`PoolExhausted` with the slot's table cleaned."""
        model = self.model
        cache = self._kv_cache()
        n = int(tokens.shape[0])
        nodes: list = []
        matched = 0
        cow = None
        if self.prefix is not None:
            nodes, matched, cow = self.prefix.match_nodes(tokens)
        span = min(n + int(max_new), model.max_t)
        nblocks = -(-span // model.page_tokens)
        # Two-phase pinning.  Every matched block on a device page is
        # pinned into the slot's table before any room-making: a restore
        # below may spill or evict other trie pages, and a matched page
        # must never be a victim.  Then the spilled matched blocks are
        # restored one at a time, each pinned the moment it lands (ref 2,
        # so spill_candidate cannot take it while the next restores).
        # Spilled blocks can wait: evict() takes only leaves on device
        # pages, and the host tier frees nothing on its own.
        donor_pinned = False
        try:
            for b, node in enumerate(nodes):
                if node.page is not None:
                    cache.share_block(slot, b, node.page)
            if cow is not None and cow[0].page is not None:
                cache.ref[cow[0].page] += 1  # the donor's pin till copied
                donor_pinned = True
            for b, node in enumerate(nodes):
                if node.page is None:
                    self._restore_node(node)
                    cache.share_block(slot, b, node.page)
            if cow is not None and not donor_pinned:
                self._restore_node(cow[0])
                cache.ref[cow[0].page] += 1
                donor_pinned = True
            need_new = nblocks - len(nodes)
            if cache.free_pages < need_new:
                self._make_room(need_new)
            base = len(nodes)
            if cow is not None:
                pid = cache.new_block(slot, base)
                # the shared positions of the boundary block come along;
                # the divergent tail overwrites its own copy
                model.copy_page(cow[0].page, pid, cache=cache)
                base += 1
            for b in range(base, nblocks):
                cache.new_block(slot, b)
        except PoolExhausted:
            cache.release_slot_pages(slot)
            raise
        finally:
            if donor_pinned:
                cache.ref_dec(cow[0].page)
        if self.prefix is not None:
            if matched > 0:
                self._m_prefix_hit.inc()
                self._m_tok_shared.inc(matched)
            else:
                self._m_prefix_miss.inc()
            self._m_tok_computed.inc(n - matched)
        return matched

    def _restore_node(self, node) -> None:
        """Bring one spilled trie block back to a device page through the
        staging ring and ``page_in``; the node's trie pin moves tiers
        with it (the frame freed, a fresh page at ref 1)."""
        cache = self._kv_cache()
        if cache.free_pages < 1:
            self._make_room(1)
        pid = cache.alloc_page()  # ref 1: the trie's pin, now on a page
        with self.model.dispatch_lock:  # the staging tensors are shared
            staged = self._spill.upload(node.host)
            self.model.page_in(staged, pid, cache=cache)
        self._spill.free(node.host)
        node.page, node.host = pid, None
        self._m_mig_restore.inc()

    def _make_room(self, pages_needed: int) -> None:
        """Free device pages for an admission: spill cold shareable
        blocks to the host tier while it has frames, then fall back to
        evicting LRU prefix blocks.  A no-op without a prefix cache:
        ``new_block`` then raises :class:`PoolExhausted` and admission
        requeues."""
        if self.prefix is None:
            return
        cache = self._kv_cache()
        while cache.free_pages < pages_needed:
            if self._spill is not None and not self._spill.full:
                victim = self.prefix.spill_candidate(cache)
                if victim is not None:
                    # the export is fenced before the page is freed
                    hid = self._spill.store(self.model.export_page(
                        victim.page, cache=cache))
                    cache.ref_dec(victim.page)  # the trie held it alone
                    victim.page, victim.host = None, hid
                    self._m_mig_spill.inc()
                    continue
            evicted = self.prefix.evict(cache, pages_needed)
            if evicted:
                _metrics.prefix_cache_events(self._obs_id,
                                             "evicted").inc(evicted)
            return


class DecodeEngine(_PageSetupMixin, Logger):
    """Continuous-batching token server over a :class:`DecodeModel`.

    ::

        with DecodeEngine("lm.npz", max_slots=4, max_t=64) as eng:
            tokens = eng.generate(prompt)            # sync
            future = eng.submit(prompt)              # async
            tokens = future.result()                 # np.int32 ids

    ``temperature=0`` (the default) decodes greedily, token-identical to
    the numpy oracle; ``temperature>0`` samples from the softmax on the
    host with a generator seeded by ``seed``.

    ``admission="continuous"`` admits queued prompts into the in-flight
    batch between token steps; ``"static"`` only when the batch has
    drained.  ``deadline_ms`` bounds TTFT (a prompt still queued past it
    fails with :class:`DeadlineExceeded` and never takes a slot); the
    circuit breaker sheds new prompts with :class:`Overloaded` while the
    sequences in flight decode to completion; pool exhaustion trips the
    same breaker.  ``spill_pages`` (or ``engine.kv_spill_pages``) above 0
    puts a host-DRAM tier of that many page-locked frames behind the
    prefix cache: under pool pressure a cold prefix block spills to a
    frame instead of being evicted, and a later match restores it, so
    the shareable working set is ``pool_pages + spill_pages``."""

    def __init__(self, model, *, max_slots: int = 4, max_t: int = 64,
                 max_prompt: int | None = None, prompt_align: int = 8,
                 max_new_tokens: int = 32, eos_token: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 max_queue: int = 256, admission: str = "continuous",
                 retry_budget: int = 1,
                 breaker_failure_rate: float = 0.5,
                 breaker_window: int = 8, breaker_min_samples: int = 4,
                 breaker_cooldown_ms: float = 1000.0,
                 paged: bool | None = None,
                 page_tokens: int | None = None,
                 pool_tokens: int | None = None,
                 prefix_cache: bool | None = None,
                 spec_draft_k: int | None = None, drafter=None,
                 max_queue_tokens: int | None = None,
                 max_queue_age_ms: float = 10_000.0,
                 kv_quant: bool | None = None, kv_dtype=None,
                 spill_pages: int | None = None, device=None) -> None:
        super().__init__()
        if not isinstance(model, DecodeModel):
            from znicz_tpu_torch.export import ExportedModel
            if isinstance(model, (str, bytes)) \
                    or hasattr(model, "__fspath__"):
                model = ExportedModel.load(model, device=device)
            decode_meta = model.decode_meta
            explicit_k = spec_draft_k is not None
            if spec_draft_k is None:
                spec_draft_k = int(decode_meta.get(
                    "spec_draft_k",
                    root.common.engine.get("spec_draft_k", 0)))
            if drafter is None:
                drafter = decode_meta.get("drafter")
            if drafter is None:
                if explicit_k and spec_draft_k:
                    raise ValueError(
                        "spec_draft_k > 0 needs a drafter bundle (path, "
                        "ExportedModel or DecodeModel)")
                spec_draft_k = 0  # default-config engines: spec off
            model = DecodeModel(model, max_slots=max_slots, max_t=max_t,
                                max_prompt=max_prompt,
                                prompt_align=prompt_align, device=device,
                                paged=paged, page_tokens=page_tokens,
                                pool_tokens=pool_tokens,
                                spec_k=int(spec_draft_k or 0),
                                kv_quant=kv_quant, kv_dtype=kv_dtype)
        self.model = model
        self.spec_k = int(model.spec_k)
        # the drafter: a small bundle decoding through its own flat cache
        # at the same geometry, on the same slot ids as the big model
        self.drafter: DecodeModel | None = None
        if self.spec_k:
            if drafter is None:
                raise ValueError(
                    "spec_draft_k > 0 needs a drafter bundle (path, "
                    "ExportedModel or DecodeModel)")
            if not isinstance(drafter, DecodeModel):
                drafter = DecodeModel(
                    drafter, max_slots=model.max_slots, max_t=model.max_t,
                    max_prompt=model.max_prompt,
                    prompt_align=model.prompt_align,
                    device=device if device is not None else model.device,
                    paged=False, spec_k=0)
            if drafter.vocab != model.vocab:
                raise ValueError(
                    f"drafter vocab {drafter.vocab} != model vocab "
                    f"{model.vocab} — the draft/verify token spaces must "
                    f"agree")
            self.drafter = drafter
        if prefix_cache is None:
            prefix_cache = bool(root.common.engine.get("prefix_cache", True))
        # prefix sharing needs position-indexed state only (an LSTM's
        # carry sums up its whole prefix in one vector)
        self.prefix_cache_enabled = bool(
            prefix_cache and model.paged and not model.has_lstm)
        self.prefix = (PrefixCache(model.page_tokens)
                       if self.prefix_cache_enabled else None)
        # the host-DRAM tier behind the trie: its restores land in the
        # model's staging tensors
        if spill_pages is None:
            spill_pages = int(root.common.engine.get("kv_spill_pages", 0))
        self._spill = None
        if self.prefix_cache_enabled and int(spill_pages) > 0:
            from znicz_tpu_torch.memory import HostPageTier
            self._spill = HostPageTier(model.page_shapes(), int(spill_pages),
                                       targets=model.page_stage)
        self._token_budget = None
        if model.paged:
            budget = (int(max_queue_tokens) if max_queue_tokens
                      else 16 * model.pool_tokens)
            self._token_budget = TokenBudget(budget)
        #: a full pool with a young queue is ordinary backlog; only a
        #: queue whose head is older than this sheds
        self.max_queue_age = float(max_queue_age_ms) / 1e3
        if admission not in ("continuous", "static"):
            raise ValueError(f"admission must be 'continuous' or "
                             f"'static', got {admission!r}")
        self.admission = admission
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = eos_token
        self.temperature = float(temperature)
        self.max_queue = int(max_queue)
        self.retry_budget = max(0, int(retry_budget))
        self.breaker_failure_rate = float(breaker_failure_rate)
        self.breaker_min_samples = int(breaker_min_samples)
        self.breaker_cooldown = float(breaker_cooldown_ms) / 1e3
        self._rng = np.random.default_rng(seed)
        wf_name = model.model.manifest.get("workflow", "model")
        self._obs_id = f"{wf_name}#decode{next(_DECODE_SEQ)}"
        self._m_submitted = _metrics.serving_requests(self._obs_id,
                                                      "submitted")
        self._m_served = _metrics.serving_requests(self._obs_id, "served")
        self._m_rejected = _metrics.serving_requests(self._obs_id,
                                                     "rejected")
        self._m_ttft = _metrics.serving_ttft_seconds(self._obs_id)
        self._m_token = _metrics.serving_token_seconds(self._obs_id)
        self._m_tok_prompt = _metrics.serving_tokens(self._obs_id, "prompt")
        self._m_tok_gen = _metrics.serving_tokens(self._obs_id, "generated")
        self._m_slots = _metrics.serving_decode_slots(self._obs_id)
        self._m_state = _metrics.serving_breaker_state(self._obs_id)
        self._m_state.set(_STATE_CODE[_CLOSED])
        self._m_swap_pause = _metrics.swap_pause_seconds(self._obs_id)
        if model.paged:
            _metrics.kv_pages_total(self._obs_id).set(model.cache.pool_pages)
            _metrics.kv_pages_used(self._obs_id).set_function(
                model.cache.pages_used)
        _metrics.kv_bytes_per_lane(self._obs_id).set(
            model.cache.nbytes() / max(1, model.max_slots))
        self._m_mig_spill = _metrics.kv_page_migrations(self._obs_id,
                                                        "spill")
        self._m_mig_restore = _metrics.kv_page_migrations(self._obs_id,
                                                          "restore")
        if self._spill is not None:
            tier = self._spill
            _metrics.kv_spill_pages(self._obs_id).set_function(
                lambda: tier.used)
        _metrics.serving_queue_age_seconds(
            self._obs_id, pool="all").set_function(self._queue_age)
        self._m_prefix_hit = _metrics.prefix_cache_events(self._obs_id,
                                                          "hit")
        self._m_prefix_miss = _metrics.prefix_cache_events(self._obs_id,
                                                           "miss")
        self._m_tok_shared = _metrics.prefix_tokens(self._obs_id, "shared")
        self._m_tok_computed = _metrics.prefix_tokens(self._obs_id,
                                                      "computed")
        self._m_spec_acc = _metrics.spec_tokens(self._obs_id, "accepted")
        self._m_spec_rej = _metrics.spec_tokens(self._obs_id, "rejected")
        self.page_truncations = 0
        #: a breaker opened by pool pressure closes again the moment a
        #: requeued prompt admits
        self._pool_tripped = False
        # exact-value windows for percentiles
        self._ttft_win: deque = deque(maxlen=4096)
        self._token_win: deque = deque(maxlen=4096)
        # per-phase latency windows fed by the request traces, read by
        # the znicz_phase_p99_seconds gauges
        self._phase_win: dict[str, deque] = {
            p: deque(maxlen=4096)
            for p in ("queue", "prefill", "handoff", "decode")}
        for _p, _win in self._phase_win.items():
            _metrics.phase_p99_seconds(self._obs_id, _p).set_function(
                lambda w=_win: _metrics.window_p99(w))
        _metrics.phase_p99_seconds(self._obs_id, "ttft").set_function(
            lambda w=self._ttft_win: _metrics.window_p99(w))
        _metrics.phase_p99_seconds(self._obs_id, "token").set_function(
            lambda w=self._token_win: _metrics.window_p99(w))
        #: queued prompts in priority classes, FIFO within a class
        self._pending = PriorityQueue()
        self._live: list[_Live] = []
        self._cond = threading.Condition()
        self._stop = False
        self._state = _CLOSED
        self._opened_at = 0.0
        self._outcomes: deque[bool] = deque(maxlen=int(breaker_window))
        self.expired_total = 0
        self.shed_total = 0
        self.retries_total = 0
        self.warmup_compiles = 0
        self.warmup_seconds = 0.0
        self._thread: threading.Thread | None = None
        self._started = False
        # a pending swap the scheduler applies between token steps once
        # the old model's lanes drained (or the drain bound passed)
        self._swap_req: dict | None = None
        self.model_version = 0
        self._m_version = _metrics.model_version(self._obs_id)
        self._m_version.set(0)
        self._m_swap_dur = _metrics.swap_duration_seconds(self._obs_id)
        self.swap_counts = {"promoted": 0, "rejected": 0, "rolled_back": 0}
        self._swap_pauses: list[float] = []

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "DecodeEngine":
        if self._started:
            return self
        t0 = time.monotonic()
        self.warmup_compiles = self.model.warmup(
            prefix_cache=self.prefix_cache_enabled,
            page_io=self._spill is not None)
        if self.drafter is not None:
            self.warmup_compiles += self.drafter.warmup()
        self.warmup_seconds = time.monotonic() - t0
        self._thread = threading.Thread(target=self._loop,
                                        name="decode-scheduler",
                                        daemon=True)
        self._started = True
        self._thread.start()
        self.info(
            "decode '%s': %d programs made resident in %.2fs (graphed=%s; "
            "prompt buckets %s, batch buckets %s, block buckets %s, "
            "slots=%d, max_t=%d, paged=%s, prefix_cache=%s, spec_k=%d, "
            "cache=%.1f MB, spill_pages=%d)",
            self.model.model.manifest.get("workflow", "?"),
            self.warmup_compiles, self.warmup_seconds, self.model.graphed,
            self.model.prompt_ladder(), self.model.batch_ladder(),
            self.model.block_ladder(), self.model.max_slots,
            self.model.max_t, self.model.paged, self.prefix_cache_enabled,
            self.spec_k, self.model.cache.nbytes() / 1e6,
            self._spill.capacity if self._spill is not None else 0)
        return self

    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain: everything admitted generates to completion, queued
        prompts are served, then the scheduler exits."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        self._started = False
        if self._spill is not None:
            self._spill.shutdown()
        # a stopped engine is not shedding: its last breaker state must
        # not keep the process not-ready
        with self._cond:
            self._state = _CLOSED
            self._outcomes.clear()
            self._m_state.set(_STATE_CODE[_CLOSED])

    def __enter__(self) -> "DecodeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int | None = None,
               deadline_ms: float | None = None, tenant: str | None = None,
               priority: int = 0) -> Future:
        """Enqueue a prompt (1-D token ids); returns a future of the
        generated ids (np.int32, from the first sampled token).  Raises
        :class:`QueueFull` under backpressure and :class:`Overloaded`
        while the breaker sheds; the future fails with
        :class:`DeadlineExceeded` if ``deadline_ms`` passes before the
        first token.  Queued prompts admit in strict priority order, and
        a full token budget sheds the newest strictly lower-priority
        queued prompts to make room."""
        if not self._started:
            raise RuntimeError("engine not started — call start()")
        prompt = np.asarray(np.round(np.asarray(prompt, np.float64)),
                            np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.model.max_prompt:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds max_prompt "
                f"{self.model.max_prompt} — truncate client-side")
        if deadline_ms is not None and deadline_ms <= 0:
            raise DeadlineExceeded(
                f"deadline_ms={deadline_ms} already expired at submit")
        req = _PromptReq(prompt, max_new_tokens or self.max_new_tokens,
                         deadline_ms, tenant=tenant, priority=priority)
        preempted: list[_PromptReq] = []
        with self._cond:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._breaker_tick(time.monotonic())
            if self._state == _OPEN:
                self.shed_total += 1
                _metrics.serving_requests(self._obs_id, "shed").inc()
                self._m_rejected.inc()
                req.trace.event("breaker_shed", engine=self._obs_id)
                self._finish_trace(req, "shed")
                raise Overloaded(
                    "circuit breaker open — new prompts shed while "
                    "in-flight decodes drain (retry after "
                    f"{self.breaker_cooldown * 1e3:.0f}ms)")
            if len(self._pending) >= self.max_queue:
                self._m_rejected.inc()
                self._finish_trace(req, "shed")
                raise QueueFull(
                    f"decode queue full ({len(self._pending)} prompts "
                    f"pending, limit {self.max_queue})")
            if self._token_budget is not None:
                # the queue is bounded by the tokens it holds (prompt +
                # budget), the bound that matches a pool of tokens
                want = req.n + req.max_new
                if not self._token_budget.try_acquire(want):
                    preempted = self._make_budget_room(req, want)
                    if not self._token_budget.try_acquire(want):
                        self._m_rejected.inc()
                        self._finish_trace(req, "shed")
                        raise QueueFull(
                            f"decode token budget full "
                            f"({self._token_budget.used} of "
                            f"{self._token_budget.capacity} tokens held; "
                            f"request wants {want})")
                req.charged = want
            self._pending.append(req)
            self._cond.notify_all()
        for victim in preempted:  # fail outside the condition
            victim.trace.event("preempted", engine=self._obs_id)
            self._finish_trace(victim, "shed")
            if not victim.future.done():
                victim.future.set_exception(Overloaded(
                    "preempted by higher-priority traffic while the "
                    "decode token budget was full"))
        self._m_submitted.inc()
        return req.future

    def _make_budget_room(self, req: _PromptReq,
                          want: int) -> list[_PromptReq]:
        """Evict queued strictly lower-priority prompts, newest first,
        until ``want`` tokens fit; returns the victims (failed by the
        caller outside the lock).  Call under ``_cond``."""
        victims: list[_PromptReq] = []
        if self._token_budget is None:
            return victims
        evictable = sorted(
            (r for r in self._pending
             if r.priority > req.priority and r.charged),
            key=lambda r: r.t_submit, reverse=True)
        if sum(r.charged for r in evictable) \
                + self._token_budget.available < want:
            return victims  # preemption cannot make room: shed req
        for victim in evictable:
            if self._token_budget.available >= want:
                break
            victims.append(victim)
            self._refund(victim)
            self.shed_total += 1
            _metrics.serving_requests(self._obs_id, "shed").inc()
        removed = set(map(id, victims))
        self._pending.sweep(lambda r: id(r) in removed)
        return victims

    def _refund(self, req: _PromptReq) -> None:
        if req.charged and self._token_budget is not None:
            self._token_budget.release(req.charged)
            req.charged = 0

    def generate(self, prompt, timeout: float | None = None,
                 **kwargs) -> np.ndarray:
        """Synchronous convenience: submit and wait."""
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    # ------------------------------------------------------------------
    # weight hot-swap
    # ------------------------------------------------------------------
    def current_bundle(self) -> tuple:
        """The live ``(manifest, params)``."""
        return (self.model.model.manifest, dict(self.model.model._params))

    def swap_weights(self, state, *, version: int | None = None,
                     drain_ms: float | None = None,
                     timeout: float | None = None,
                     outcome: str = "promoted") -> dict:
        """Hot-swap the decode weights with no new program.

        Generations in flight belong to the old weights: the scheduler
        stops admitting, lets the live lanes decode to completion, then
        publishes the new weights and clears the prefix cache (its K/V
        are the old weights').  Lanes still live after ``drain_ms``
        (default ``engine.swap_drain_ms``) finish with their tokens so
        far.  Queued prompts prefill on the new weights.  Raises
        :class:`~znicz_tpu_torch.export.SwapIncompatible` before any
        drain."""
        from znicz_tpu_torch.serving.engine import resolve_swap_state
        manifest, params = resolve_swap_state(state)
        self.model.check_compatible(manifest, params)
        if drain_ms is None:
            drain_ms = float(root.common.engine.get("swap_drain_ms",
                                                    2000.0))
        t0 = time.monotonic()
        if not self._started:
            self.model.swap_weights(params, manifest=manifest)
            self._clear_prefix()
            drain = {"drained": 0, "evicted": 0, "drain_ms": 0.0}
        else:
            fut: Future = Future()
            with self._cond:
                if self._swap_req is not None:
                    raise RuntimeError(
                        "a weight swap is already in progress")
                self._swap_req = {
                    "manifest": manifest, "params": params,
                    "deadline": t0 + float(drain_ms) / 1e3,
                    "future": fut, "t0": t0, "live0": len(self._live)}
                self._cond.notify_all()
            drain = fut.result(
                timeout if timeout is not None
                else max(60.0, float(drain_ms) / 1e3 + 60.0))
        pause = time.monotonic() - t0
        if version is None:
            version = self.model_version + 1
        self.model_version = int(version)
        self._m_version.set(self.model_version)
        self._m_swap_dur.observe(pause)
        self._swap_pauses.append(pause)
        self.record_swap_outcome(outcome)
        self.info(
            "decode weights hot-swapped → version %d (%s, %.1f ms pause, "
            "%d lanes drained, %d evicted at the drain bound)",
            self.model_version, outcome, 1e3 * pause,
            drain.get("drained", 0), drain.get("evicted", 0))
        return {"version": self.model_version, "outcome": outcome,
                "pause_ms": round(1e3 * pause, 3),
                "weights_version": self.model.weights_version, **drain}

    def record_swap_outcome(self, outcome: str) -> None:
        self.swap_counts[outcome] = self.swap_counts.get(outcome, 0) + 1
        _metrics.swaps_total(self._obs_id, outcome).inc()
        _recorder.record("swap", engine=self._obs_id, outcome=outcome,
                         version=self.model_version)

    def set_model_version(self, version: int) -> None:
        """Label the loaded bundle's published version."""
        self.model_version = int(version)
        self._m_version.set(self.model_version)

    def swap_pauses_ms(self) -> list[float]:
        return [1e3 * p for p in self._swap_pauses]

    def _clear_prefix(self) -> None:
        """Drop every cached prefix block (their K/V are the old
        weights')."""
        if self.prefix is not None:
            dropped = self.prefix.clear(self.model.cache, tier=self._spill)
            if dropped:
                self.info("prefix cache invalidated by weight swap (%d "
                          "cached blocks dropped)", dropped)

    def _maybe_apply_swap(self, force: bool = False) -> None:
        """The scheduler's half of a swap: once no old-model lane is live
        (or the drain bound or shutdown forces it), finish the stragglers
        with their tokens so far, publish the weights, clear the prefix
        cache and resume admission."""
        req = self._swap_req
        if req is None:
            return
        now = time.monotonic()
        if self._live and not force and now < req["deadline"]:
            return  # still draining old-model generations
        evicted = 0
        for s in self._live:
            self._finish(s)
            evicted += 1
        self._live = []
        self._m_slots.set(0)
        try:
            self.model.swap_weights(req["params"], manifest=req["manifest"])
        except Exception as exc:  # noqa: BLE001 — report to the caller
            req["future"].set_exception(exc)
        else:
            req["future"].set_result({
                "drained": req.get("live0", 0) - evicted,
                "evicted": evicted,
                "drain_ms": round(1e3 * (now - req["t0"]), 3)})
        self._clear_prefix()
        with self._cond:
            # the drain pause is a swap-policy cost, not serving latency:
            # the queued requests' TTFT and deadline clocks skip it, and
            # it lands on its own counter
            pause_end = time.monotonic()
            self._m_swap_pause.inc(max(0.0, pause_end - req["t0"]))
            for r in self._pending:
                paused = max(0.0, pause_end - max(r.t_submit, req["t0"]))
                r.pause_s += paused
                if paused > 0.0:
                    r.trace.event("swap_pause", engine=self._obs_id,
                                  pause_ms=round(1e3 * paused, 3))
            self._swap_req = None
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # breaker (under _cond)
    # ------------------------------------------------------------------
    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        self.warning("decode breaker %s → %s", self._state, state)
        _recorder.record("breaker", engine=self._obs_id, src=self._state,
                         to=state)
        self._state = state
        if state == _OPEN:
            self._opened_at = time.monotonic()
        self._m_state.set(_STATE_CODE[state])
        _metrics.serving_breaker_transitions(self._obs_id, state).inc()

    def _breaker_tick(self, now: float) -> None:
        if self._state == _OPEN \
                and now - self._opened_at >= self.breaker_cooldown:
            self._transition(_HALF_OPEN)

    def _record_outcome(self, ok: bool) -> None:
        with self._cond:
            if self._state == _HALF_OPEN:
                self._transition(_CLOSED if ok else _OPEN)
                self._outcomes.clear()
                return
            self._outcomes.append(ok)
            n = len(self._outcomes)
            if n >= self.breaker_min_samples:
                rate = self._outcomes.count(False) / n
                if rate >= self.breaker_failure_rate \
                        and self._state != _OPEN:
                    self.warning("decode breaker tripped: failure rate "
                                 "%.0f%% over %d dispatches", 100 * rate, n)
                    self._transition(_OPEN)
                    self._outcomes.clear()

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def _sample(self, logits: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits))
        z = logits / self.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _sweep_expired(self, now: float) -> None:
        """Fail the queued prompts whose TTFT deadline passed (they never
        reach prefill).  The clock stops while a swap drain pauses
        admission.  Call under ``_cond``."""
        if self._swap_req is not None:
            return
        if not any(r.deadline is not None for r in self._pending):
            return
        for req in self._pending.sweep(lambda r: r.expired(now)):
            self.expired_total += 1
            _metrics.serving_requests(self._obs_id, "expired").inc()
            self._refund(req)
            req.trace.event("deadline_evicted", engine=self._obs_id)
            self._finish_trace(req, "expired")
            req.future.set_exception(DeadlineExceeded(
                f"TTFT deadline passed after "
                f"{(now - req.t_submit - req.pause_s) * 1e3:.0f}ms "
                f"admission-eligible in queue"))

    def _chaos(self) -> None:
        spike = _faults.fire("serving.latency_spike")
        if spike is not None:
            time.sleep(float(spike.get("ms", 50.0)) / 1e3)
        if _faults.fire("serving.program_error") is not None:
            raise _faults.FaultInjected("injected decode program failure")

    def _dispatch(self, fn, *args):
        """One program dispatch under the retry budget and the breaker's
        accounting.  A retry reruns against the caches as they are: on
        the CPU only, as a failed graph on the card may have written
        them."""
        attempts = 0
        budget = 0 if self.model.donating else self.retry_budget
        while True:
            try:
                self._chaos()
                out = fn(*args)
            except Exception:
                self._record_outcome(False)
                if attempts >= budget:
                    raise
                attempts += 1
                self.retries_total += 1
                _metrics.serving_requests(self._obs_id, "retried").inc()
                continue
            self._record_outcome(True)
            if attempts:
                _metrics.recoveries("serving_retry").inc()
            return out

    def _end_phase(self, req: _PromptReq, phase: str, **args) -> float:
        """Close one trace phase and feed the phase's p99 window from the
        same measurement."""
        dur = req.trace.phase_end(phase, engine=self._obs_id, **args)
        if dur > 0.0:
            win = self._phase_win.get(phase)
            if win is not None:
                win.append(dur)
        return dur

    def _finish_trace(self, req: _PromptReq, outcome: str) -> None:
        _metrics.trace_requests(self._obs_id, outcome).inc()
        req.trace.finish(outcome)

    def _release_lane(self, live: _Live) -> None:
        if self.model.paged:
            self.model.cache.release_slot_pages(live.slot)
        self.model.cache.release(live.slot)
        self._refund(live.req)

    def _finish(self, live: _Live) -> None:
        self._release_lane(live)
        self._m_served.inc()
        self._end_phase(live.req, "decode", tokens=len(live.generated))
        self._finish_trace(live.req, "ok")
        if not live.req.future.done():
            live.req.future.set_result(np.asarray(live.generated, np.int32))

    def _fail_lane(self, live: _Live, exc: Exception) -> None:
        self._release_lane(live)
        self._finish_trace(live.req, "failed")
        if not live.req.future.done():
            live.req.future.set_exception(exc)

    def _admit_cleanup(self, req: _PromptReq, slot: int,
                       exc: Exception) -> None:
        if self.model.paged:
            self.model.cache.release_slot_pages(slot)
        self.model.cache.release(slot)
        self._refund(req)
        self.warning("prefill failed: %s", exc)
        self._finish_trace(req, "failed")
        if not req.future.done():
            req.future.set_exception(exc)

    def _post_prefill(self, req: _PromptReq, slot: int,
                      logits: np.ndarray) -> None:
        """Admission bookkeeping once a prompt's first logits exist: trie
        registration, TTFT, the first sample, the live lane."""
        if self.prefix is not None:
            self.prefix.insert(req.tokens, self.model.cache.tables[slot],
                               self.model.cache)
        token = self._sample(logits)
        self._end_phase(req, "prefill", tokens=req.n)
        req.trace.phase_begin("decode")
        ttft = time.monotonic() - req.t_submit - req.pause_s
        req.future.ttft_s = ttft
        self._m_ttft.observe(ttft)
        self._ttft_win.append(ttft)
        self._m_tok_prompt.inc(req.n)
        self._m_tok_gen.inc()
        live = _Live(req, slot, token)
        if (self.eos_token is not None and token == self.eos_token) \
                or req.max_new <= 1:
            self._finish(live)
            return
        self._live.append(live)
        self._m_slots.set(len(self._live))

    def _admit_prefilled(self, req: _PromptReq, slot: int,
                         matched: int) -> None:
        """One prompt's prefill for a slot whose pages are set up
        (``matched`` tokens on shared pages)."""
        self._end_phase(req, "queue")
        req.trace.phase_begin("prefill")
        try:
            with _tracing.TRACER.span("prefill", cat="serving",
                                      tokens=req.n, shared=matched):
                logits = self._dispatch(self.model.run_prefill,
                                        req.tokens[matched:], slot, matched)
                if self.drafter is not None:
                    # the drafter takes the whole prompt into its own flat
                    # cache
                    self._dispatch(self.drafter.run_prefill, req.tokens,
                                   slot)
        except Exception as exc:  # noqa: BLE001 — isolate the prompt
            self._admit_cleanup(req, slot, exc)
            return
        self._post_prefill(req, slot, logits)

    def _admit_window(self, group: list[tuple]) -> None:
        """Admission coalescing: a wave of prompts whose unshared tails
        fit one ``prompt_align`` window pays one window dispatch."""
        w_len = self.model.prompt_align
        n = len(group)
        windows = np.zeros((n, w_len), np.int32)
        slots = np.empty((n,), np.int32)
        starts = np.empty((n,), np.int32)
        lengths = np.empty((n,), np.int32)
        for i, (req, slot, matched) in enumerate(group):
            tail = req.tokens[matched:]
            windows[i, :len(tail)] = tail
            slots[i] = slot
            starts[i] = matched
            lengths[i] = len(tail)
        for req, _slot, _m in group:
            self._end_phase(req, "queue")
            req.trace.phase_begin("prefill")
        try:
            with _tracing.TRACER.span("prefill_window", cat="serving",
                                      lanes=n, w=w_len):
                logits = self._dispatch(self.model.run_window, windows,
                                        slots, starts, lengths,
                                        "serving-prefill")
                if self.drafter is not None:
                    for req, slot, _m in group:
                        self._dispatch(self.drafter.run_prefill,
                                       req.tokens, slot)
        except Exception as exc:  # noqa: BLE001 — isolate the wave
            for req, slot, _m in group:
                self._admit_cleanup(req, slot, exc)
            return
        for i, (req, slot, _m) in enumerate(group):
            self._post_prefill(req, slot, logits[i, int(lengths[i]) - 1])

    def _admit_many(self, reqs: list[_PromptReq]) -> list[_PromptReq]:
        """Admit a wave of prompts; returns the suffix to requeue when
        the pool cannot hold one (order kept).  Prompts match the trie in
        order and a miss prefills (and registers its blocks) at once, so
        the next request of a burst already shares them; the prefix-hit
        tails then coalesce into one window."""
        model = self.model
        window: list[tuple] = []
        requeue: list[_PromptReq] = []
        for i, req in enumerate(reqs):
            slot = model.cache.acquire()
            matched = 0
            if model.paged:
                try:
                    matched = self._setup_pages(slot, req.tokens,
                                                req.max_new)
                except PoolExhausted:
                    model.cache.release(slot)
                    requeue = list(reqs[i:])
                    break
                if self._pool_tripped:
                    with self._cond:  # capacity is back: take traffic
                        self._pool_tripped = False
                        if self._state == _OPEN:
                            self._transition(_CLOSED)
            if (self.prefix is not None and not model.has_lstm
                    and 0 < req.n - matched <= model.prompt_align):
                window.append((req, slot, matched))
            else:
                self._admit_prefilled(req, slot, matched)
        if len(window) == 1:
            self._admit_prefilled(*window[0])
        elif window:
            self._admit_window(window)
        return requeue

    def _emit_tokens(self, s: _Live, tokens: list[int], now: float) -> bool:
        """Append emitted tokens to a lane; True when it finished (EOS,
        its budget, or max_t)."""
        dt = (now - s.t_last) / max(1, len(tokens))
        done = False
        for tok in tokens:
            s.pos += 1
            s.generated.append(int(tok))
            self._m_token.observe(dt)
            self._token_win.append(dt)
            self._m_tok_gen.inc()
            if ((self.eos_token is not None and int(tok) == self.eos_token)
                    or len(s.generated) >= s.req.max_new
                    or s.pos >= self.model.max_t):
                done = True
                break
        s.t_last = now
        return done

    def _fail_all(self, what: str, exc: Exception) -> None:
        self.warning("%s failed for %d lanes: %s", what, len(self._live),
                     exc)
        for s in self._live:
            self._fail_lane(s, exc)
        self._live = []
        self._m_slots.set(0)

    def _step(self) -> None:
        """One token step over every live lane (admission reserved every
        block a real token can land in: no page bookkeeping here)."""
        live = self._live
        if not live:
            return
        tokens = np.asarray([s.generated[-1] for s in live], np.int32)
        slots = np.asarray([s.slot for s in live], np.int32)
        positions = np.asarray([s.pos for s in live], np.int32)
        try:
            with _tracing.TRACER.span("decode_step", cat="serving",
                                      lanes=len(live)):
                logits = self._dispatch(self.model.run_decode, tokens,
                                        slots, positions)
        except Exception as exc:  # noqa: BLE001 — the step is shared
            self._fail_all("decode step", exc)
            return
        now = time.monotonic()
        still: list[_Live] = []
        for i, s in enumerate(live):
            if self._emit_tokens(s, [self._sample(logits[i])], now):
                self._finish(s)
            else:
                still.append(s)
        self._live = still
        self._m_slots.set(len(still))

    # -- speculative decoding -------------------------------------------
    def _softmax(self, logits: np.ndarray) -> np.ndarray:
        z = logits / max(self.temperature, 1e-9)
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        return p / p.sum(axis=-1, keepdims=True)

    def _accept_lane(self, vlogits: np.ndarray, drafts: np.ndarray,
                     qrow: np.ndarray | None) -> tuple[list[int], int]:
        """Leviathan's rule for one lane: ``vlogits`` (k+1, V) the
        verifier's logits, ``drafts`` (k,), ``qrow`` (k, V) the drafter's
        probabilities (sampling only).  Returns ``(emitted, accepted)``.
        Greedy accepts while the verifier's argmax equals the draft and
        emits the verifier's token at the first mismatch; no bonus token
        on a full accept (the drafter never took the last draft, so the
        next round feeds it)."""
        emitted: list[int] = []
        accepted = 0
        for i in range(self.spec_k):
            d = int(drafts[i])
            if qrow is None:  # greedy
                g = int(np.argmax(vlogits[i]))
                emitted.append(g)
                if g != d:
                    break
                accepted += 1
            else:  # temperature: exact rejection sampling
                p = self._softmax(vlogits[i])
                q = qrow[i]
                if self._rng.random() < min(
                        1.0, float(p[d]) / max(float(q[d]), 1e-12)):
                    emitted.append(d)
                    accepted += 1
                    continue
                resid = np.maximum(p - q, 0.0)
                total = resid.sum()
                probs = resid / total if total > 0 else p
                emitted.append(int(self._rng.choice(len(p), p=probs)))
                break
        return emitted, accepted

    def _step_spec(self) -> None:
        """One speculative step: k drafter tokens a lane, one batched
        verification window, 1..k tokens emitted a lane.  The window's
        overhang past a lane's reservation holds only discardable draft
        positions, which the tables send to the trash page."""
        k = self.spec_k
        live = self._live
        if not live:
            return
        n = len(live)
        slots = np.asarray([s.slot for s in live], np.int32)
        base_pos = np.asarray([s.pos for s in live], np.int32)
        cur = np.asarray([s.generated[-1] for s in live], np.int32)
        drafts = np.empty((n, k), np.int32)
        qprobs = (np.empty((n, k, self.model.vocab), np.float64)
                  if self.temperature > 0 else None)
        try:
            with _tracing.TRACER.span("spec_draft", cat="serving", lanes=n,
                                      k=k):
                for j in range(k):
                    dlogits = self._dispatch(self.drafter.run_decode, cur,
                                             slots, base_pos + j)
                    if qprobs is None:
                        nxt = np.argmax(dlogits, axis=1)
                    else:
                        q = self._softmax(dlogits)
                        qprobs[:, j] = q
                        nxt = np.asarray([self._rng.choice(q.shape[1],
                                                           p=q[i])
                                          for i in range(n)])
                    drafts[:, j] = nxt
                    cur = nxt.astype(np.int32)
            windows = np.concatenate(
                [np.asarray([[s.generated[-1]] for s in live], np.int32),
                 drafts], axis=1)
            with _tracing.TRACER.span("spec_verify", cat="serving",
                                      lanes=n, k=k):
                vlogits = self._dispatch(self.model.run_verify, windows,
                                         slots, base_pos)
        except Exception as exc:  # noqa: BLE001 — the step is shared
            self._fail_all("speculative step", exc)
            return
        now = time.monotonic()
        still: list[_Live] = []
        for i, s in enumerate(live):
            emitted, accepted = self._accept_lane(
                vlogits[i], drafts[i], None if qprobs is None else qprobs[i])
            self._m_spec_acc.inc(accepted)
            self._m_spec_rej.inc(k - accepted)
            if self._emit_tokens(s, emitted, now):
                self._finish(s)
            else:
                still.append(s)
        self._live = still
        self._m_slots.set(len(still))

    def _loop(self) -> None:
        while True:
            admit: list[_PromptReq] = []
            with self._cond:
                while (not self._pending and not self._live
                       and not self._stop and self._swap_req is None):
                    self._cond.wait(timeout=0.25)
                    self._sweep_expired(time.monotonic())
                if self._stop and not self._pending and not self._live:
                    # a swap still pending at shutdown applies now: its
                    # caller waits on the future
                    self._maybe_apply_swap(force=True)
                    return
                now = time.monotonic()
                self._sweep_expired(now)
                self._breaker_tick(now)
                # nothing admits during a swap drain: queued prompts
                # prefill on the new weights
                may_admit = (self._swap_req is None
                             and (self.admission == "continuous"
                                  or not self._live))
                free = self.model.cache.free_slots
                while may_admit and self._pending and len(admit) < free:
                    admit.append(self._pending.popleft())
            requeue = self._admit_many(admit)
            if requeue:
                head = None
                with self._cond:
                    self._pending.requeue_front(requeue)
                    if self._live or self._swap_req is not None:
                        # a young backlog waits for draining lanes to
                        # free pages; a stalled one sheds new prompts
                        # through the breaker until capacity returns
                        blocked = self._pending.peek()
                        head_age = (time.monotonic() - blocked.t_submit
                                    - blocked.pause_s)
                        if self._state == _CLOSED \
                                and head_age > self.max_queue_age:
                            self.warning(
                                "page pool exhausted (%d/%d pages free, "
                                "head queued %.1fs): shedding new prompts "
                                "while %d lanes drain",
                                self.model.cache.free_pages,
                                self.model.cache.pool_pages, head_age,
                                len(self._live))
                            self._transition(_OPEN)
                            self._pool_tripped = True
                    else:
                        # no lane will free a page: the prompt cannot fit
                        head = self._pending.popleft()
                if head is not None:
                    self._refund(head)
                    self._m_rejected.inc()
                    if not head.future.done():
                        head.future.set_exception(PoolExhausted(
                            f"prompt of {head.n} tokens cannot fit the "
                            f"{self.model.cache.pool_pages}-page pool even "
                            f"with every lane drained and the prefix cache "
                            f"evicted"))
            if self._live:
                if self.spec_k and all(s.pos + self.spec_k < self.model.max_t
                                       for s in self._live):
                    self._step_spec()
                else:
                    self._step()
            self._maybe_apply_swap()

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _queue_age(self) -> float:
        """Age of the oldest queued prompt (the gauge's callback; a racy
        peek is fine for a scrape)."""
        try:
            head = self._pending.peek()
        except RuntimeError:  # mutated mid-iteration
            return 0.0
        if head is None:
            return 0.0
        return max(0.0, time.monotonic() - head.t_submit - head.pause_s)

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

        model, drafter = self.model, self.drafter
        spec_acc = int(self._m_spec_acc.value)
        spec_rej = int(self._m_spec_rej.value)
        qkeys = getattr(model.model, "_qkeys", None)
        return {
            "engine": ("decode-paged" if model.paged
                       else "decode-bucketed")
            + ("-graphs" if model.graphed else ""),
            "admission": self.admission,
            "max_slots": model.max_slots,
            "max_t": model.max_t,
            "paged": model.paged,
            "graphed": model.graphed,
            "page_tokens": model.page_tokens if model.paged else None,
            "pages": ({
                "total": model.cache.pool_pages,
                "used": model.cache.pages_used(),
                "pool_tokens": model.pool_tokens,
                "page_truncations": self.page_truncations,
            } if model.paged else None),
            "prefix_cache": ({
                "nodes": self.prefix.nodes,
                "hits": int(self._m_prefix_hit.value),
                "misses": int(self._m_prefix_miss.value),
                "shared_tokens": int(self._m_tok_shared.value),
                "computed_tokens": int(self._m_tok_computed.value),
                "spilled_nodes": self.prefix.spilled_nodes(),
                "spill_pages_used": (self._spill.used
                                     if self._spill else 0),
                "spill_capacity": (self._spill.capacity
                                   if self._spill else 0),
                "migrations": {
                    "spill": int(self._m_mig_spill.value),
                    "restore": int(self._m_mig_restore.value),
                },
            } if self.prefix is not None else None),
            "speculative": ({
                "draft_k": self.spec_k,
                "drafter": drafter.model.manifest.get("workflow", "?"),
                "accepted": spec_acc,
                "rejected": spec_rej,
                "accept_rate": round(
                    spec_acc / max(1, spec_acc + spec_rej), 3),
            } if self.spec_k else None),
            "prompt_buckets": model.prompt_ladder(),
            "batch_buckets": model.batch_ladder(),
            "block_buckets": model.block_ladder(),
            "programs_compiled": model.compile_count
            + (drafter.compile_count if drafter else 0),
            "programs_live": model.programs_live
            + (drafter.programs_live if drafter else 0),
            "captures": model.captures
            + (drafter.captures if drafter else 0),
            "warmup_seconds": round(self.warmup_seconds, 3),
            "cache_bytes": model.cache.nbytes(),
            "kv_bytes_per_lane": model.cache.nbytes()
            // max(1, model.max_slots),
            "quant": ({
                "weights": "int8" if qkeys else "f32",
                "kv_pages": ("int8" if model.kv_quant
                             else str(model.kv_dtype)),
            } if (model.kv_quant or qkeys) else None),
            "submitted": int(self._m_submitted.value),
            "served": int(self._m_served.value),
            "rejected": int(self._m_rejected.value),
            "model_version": self.model_version,
            "weights_version": model.weights_version,
            "swaps": dict(self.swap_counts),
            "tokens_prompt": int(self._m_tok_prompt.value),
            "tokens_generated": int(self._m_tok_gen.value),
            "live_slots": len(self._live),
            "queued_prompts": len(self._pending),
            "ttft_ms": window(self._ttft_win),
            "token_ms": window(self._token_win),
            "resilience": {
                "breaker": self._state,
                "retry_budget": self.retry_budget,
                "retried": self.retries_total,
                "expired": self.expired_total,
                "shed": self.shed_total,
            },
            "token_budget": ({
                "capacity": self._token_budget.capacity,
                "used": self._token_budget.used,
                "over_released": self._token_budget.over_released,
            } if self._token_budget is not None else None),
        }

    @property
    def breaker_state(self) -> str:
        return self._state

    def ready(self) -> bool:
        return bool(self._started and self._state != _OPEN)

    def serving_status(self) -> dict:
        """``web_status.gather_status`` hook."""
        out = {"name": "decode:"
               + self.model.model.manifest.get("workflow", "?"),
               "initialized": self._started,
               "stopped": not self._started}
        out.update(self.stats())
        return out
