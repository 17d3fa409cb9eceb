"""Continuous batching: a persistent decode loop with slot admission.

The port of ``rlo_tpu/models/serve.py``'s ``DecodeServer``. A fixed pool
of ``n_slots`` batch rows decodes in rounds of up to ``round_len`` ragged
decode steps; a finished row's slot is refilled by the next queued
request without restarting the batch. Two modes:

  - DENSE (the default): admission prefills a fresh request at a padded
    prompt bucket into a one-row cache (K2 attends the prompt), extends
    prompts longer than the largest bucket with ``block_decode`` chunks
    (K8 writes, K6 attends), and copies the row into its slot in place.
    A round is a Python loop of ``decode_step``s (K7 writes, K6
    attends).
  - PAGED (``paged=True``): the per-slot dense cache becomes a global
    pool of ``page_size``-token pages per layer plus a per-slot page
    table (``models.paged``, ``serving.pages``). Prompts stream through
    chunked prefill (page-aligned forwards of at most ``page_size``
    tokens, ``paged_prefill_chunk``: K11 writes, K9 attends) interleaved
    with decode rounds; prompts sharing a prefix map the same physical
    pages through a radix trie, copy-on-write; a round is a Python loop
    of ``paged_decode_step``s (K10 writes, K9 attends) and is clipped to
    the shortest active budget (``clip_rounds``), so finished rows burn
    no slot-steps. Pools are updated in place on one stream: a page copy
    and the writes that follow it are ordered, and nothing is cloned per
    round. The page table goes to the device once per round.

In both modes the greedy pick runs on the device and the host reads a
round's tokens once at its end. MoE configs route drop-free everywhere
(``generate._decode_cfg``): the rounds, the admission prefill (ragged:
``last_index``), the extension chunks and the paged prefill chunks.

Finished rows keep decoding masked garbage until the round ends;
outputs are truncated to each request's ``max_new``, and slot reuse is
safe because every attend masks at the row's own position and cache
writes overwrite in order (a retired slot's position runs past max_len,
where K7 drops the write).

The telemetry names are the JAX package's (``serve.ttft_usec``,
``serve.queue_wait_usec``, ``serve.e2e_usec``, ``serve.round_usec``,
``serve.tok_usec``, ``serve.occupancy_pct``, the request/token counters
and the ``serve.queue_depth`` gauge; in paged mode also the
``serve.pages_in_use``/``serve.pages_free`` gauges and the
``serve.prefix_hits``, ``serve.prefix_tokens_shared``,
``serve.cow_copies``, ``serve.trie_evictions``, ``serve.prefill_chunks``
and ``serve.admission_stalls`` counters), recorded into the port's
``SERVING`` registry unless the server is handed its own.

Span hooks: a fabric that traces sets ``spans`` (a span recorder with
``sampled(rid)`` and ``emit(rid, stage, t0, t1)``) and ``span_rid_of``
(server rid -> fabric rid); the paged scheduler then emits one
``STAGE_PREFILL_CHUNK`` span per prefill chunk. With ``spans`` None it
runs no span code.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rlo_tpu_torch.models.generate import (_decode_cfg, block_decode,
                                           decode_step, init_kv_cache,
                                           prefill)
from rlo_tpu_torch.models.paged import (copy_page, init_page_pool,
                                        paged_decode_step,
                                        paged_prefill_chunk)
from rlo_tpu_torch.models.transformer import TransformerConfig, cast_params
from rlo_tpu_torch.serving.pages import PageAllocator, PrefixTrie
from rlo_tpu_torch.utils.metrics import SERVING, Registry, hist_summary

#: the span stage id of one prefill chunk (the JAX package's
#: ``observe.spans.Stage.PREFILL_CHUNK``, shared with its trace analyzer)
STAGE_PREFILL_CHUNK = 4


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` (plen,) int32, ``max_new``
    tokens to generate, and an optional ``eos_id`` that ends the row
    early (the emitted tokens include the eos)."""
    prompt: np.ndarray
    max_new: int
    eos_id: Optional[int] = None


def _bucket(plen: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if plen <= b:
            return b
    raise ValueError(f"prompt length {plen} exceeds the largest "
                     f"bucket {buckets[-1]}")


class DecodeServer:
    """Continuous-batching server over ``n_slots`` rows of one KV cache
    (dense) or one page pool (paged) on the params' device.

    submit() queues requests; run() drives rounds until every request
    completes and returns the per-request token arrays in submission
    order; step_round() is one admission pass plus one decode round.

    Paged knobs, as in the JAX package: ``page_size`` (any size off a
    TPU; 128 is the default), ``n_pages`` (pool size; the default fits
    every slot at max_len plus the null page), ``prefill_budget`` (prompt
    tokens prefilled per slot per round; None finishes a prompt at its
    admission round), ``prefix_cache`` (the radix trie) and
    ``clip_rounds`` (clip each round to the shortest active budget; on by
    default in paged mode, off in dense mode).
    """

    def __init__(self, params, cfg: TransformerConfig, *,
                 n_slots: int, max_len: int, round_len: int = 32,
                 prompt_buckets: Tuple[int, ...] = (64, 256, 1024),
                 metrics: Optional[Registry] = None,
                 # rlo-prover: lane-pinned (K8's widest block)
                 paged: bool = False, page_size: int = 128,
                 n_pages: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True,
                 clip_rounds: Optional[bool] = None):
        self.metrics = SERVING if metrics is None else metrics
        self.params = cast_params(params, cfg.act_dtype)
        self.device = self.params["embed"].device
        self.cfg = cfg
        # the rounds' config: MoE layers route drop-free
        self.cfg_d = _decode_cfg(cfg)
        self.n_slots = n_slots
        self.max_len = max_len
        self.round_len = round_len
        self.paged = paged
        self.pos = np.zeros((n_slots,), np.int32)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.budget = np.zeros((n_slots,), np.int64)  # tokens still due
        self.req_of_slot: List[Optional[int]] = [None] * n_slots
        self._queue: List[Tuple[int, Request]] = []
        self._out: List[Optional[List[int]]] = []
        self._eos: List[Optional[int]] = []
        self._submit_ts: dict = {}  # rid -> submit time, until admission
        self._accept_ts: dict = {}  # rid -> submit time, until completion
        self._canceled: set = set()
        self._completed_log: List[Tuple[int, np.ndarray]] = []
        self.rounds_run = 0
        self.steps_run = 0
        # span hooks, attached by a tracing fabric (ModelBackend)
        self.spans = None
        self.span_rid_of = None
        if paged:
            self._init_paged(page_size, n_pages, prefill_budget,
                             prefix_cache,
                             True if clip_rounds is None else clip_rounds)
            return
        self.clip_rounds = bool(clip_rounds)
        self.buckets = tuple(b for b in sorted(prompt_buckets)
                             if b <= max_len)
        if not self.buckets:
            raise ValueError(
                f"no prompt bucket fits max_len {max_len} "
                f"(buckets {tuple(sorted(prompt_buckets))})")
        self.cache = init_kv_cache(cfg, n_slots, max_len,
                                   device=self.device)
        # long prompts extend past the largest bucket in block_decode
        # chunks of this width
        self._chunk_w = min(128, self.buckets[-1])

    # ---- device work --------------------------------------------------
    def _round(self, last_tok, pos, kk: int):
        """kk ragged greedy decode steps over the whole slot pool; the
        cache is updated in place. Returns (last token, positions,
        tokens (n_slots, kk)) on the device."""
        tok = torch.as_tensor(last_tok, device=self.device)
        pos = torch.as_tensor(pos, device=self.device)
        toks = []
        for _ in range(kk):
            logits, _ = decode_step(self.params, tok, pos, self.cache,
                                    self.cfg_d)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
            toks.append(tok)
        return tok, pos, torch.stack(toks, dim=1)

    def _prefill(self, padded: np.ndarray, length: int):
        """One padded prompt row through the blockwise prefill into a
        fresh one-row cache; returns (row cache, first token)."""
        row = init_kv_cache(self.cfg, 1, self.max_len, device=self.device)
        prompt = torch.as_tensor(padded, device=self.device)
        logits, row = prefill(self.params, prompt, row, self.cfg,
                              last_index=[length - 1])
        return row, torch.argmax(logits, dim=-1).to(torch.int32)

    def _extend(self, row, toks: np.ndarray, pos0: int, n_valid: int):
        """One block_decode chunk into the row cache (in place); returns
        the greedy token after the chunk's last valid position."""
        logits, _ = block_decode(self.params,
                                 torch.as_tensor(toks, device=self.device),
                                 [pos0], row, self.cfg)
        idx = min(max(n_valid - 1, 0), toks.shape[1] - 1)
        return torch.argmax(logits[:, idx], dim=-1).to(torch.int32)

    def _scatter(self, row, slot: int) -> None:
        """Copy the one-row cache into the pool cache's slot, in place."""
        for big, small in zip(self.cache, row):
            for key, t in small.items():
                big[key][slot].copy_(t[0])

    # ---- paged mode ---------------------------------------------------
    def _init_paged(self, page_size, n_pages, prefill_budget, prefix_cache,
                    clip_rounds):
        self.page_size = page_size
        self.max_pages = -(-self.max_len // page_size)
        if n_pages is None:
            n_pages = self.n_slots * self.max_pages + 1
        self.n_pages = n_pages
        self.clip_rounds = clip_rounds
        self.prefill_budget = prefill_budget
        self.pools = init_page_pool(self.cfg, n_pages, page_size,
                                    device=self.device)
        self.allocator = PageAllocator(n_pages, page_size)
        self.trie = PrefixTrie(page_size) if prefix_cache else None
        self.table = np.zeros((self.n_slots, self.max_pages), np.int32)
        self.active = np.zeros((self.n_slots,), bool)
        #: pages owned (one reference each) per slot, table order
        self._slot_pages: List[List[int]] = \
            [[] for _ in range(self.n_slots)]
        #: slot -> in-flight chunked prefill state
        self._prefilling: Dict[int, dict] = {}

    def _round_paged(self, kk: int):
        """kk greedy paged decode steps over the whole slot pool, the
        page table sent to the device once; inactive slots keep their
        token and position. Returns (last token, positions, tokens
        (n_slots, kk)) on the device."""
        dev = self.device
        table = torch.as_tensor(self.table, device=dev)
        active = torch.as_tensor(self.active, device=dev)
        tok = torch.as_tensor(self.last_tok, device=dev)
        pos = torch.as_tensor(self.pos, device=dev)
        step = active.to(torch.int32)
        toks = []
        for _ in range(kk):
            logits, _ = paged_decode_step(self.params, tok, pos, self.pools,
                                          table, active, self.cfg_d)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            tok = torch.where(active, nxt, tok)
            pos = pos + step
            toks.append(tok)
        return tok, pos, torch.stack(toks, dim=1)

    # ---- request lifecycle --------------------------------------------
    def submit(self, prompt, max_new: int,
               eos_id: Optional[int] = None) -> int:
        """Queue a request; returns its id (position in results). Any
        prompt with plen + max_new <= max_len is admissible (paged: that
        also fits the pool); only oversized requests are rejected."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_len {self.max_len}")
        if self.paged:
            need = -(-(len(prompt) + max_new) // self.page_size)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request spans {need} pages but the pool holds "
                    f"only {self.n_pages - 1} allocatable pages")
        rid = len(self._out)
        self._queue.append((rid, Request(prompt, max_new, eos_id)))
        self._out.append(None)
        self._eos.append(eos_id)
        now = time.perf_counter()
        self._submit_ts[rid] = now
        self._accept_ts[rid] = now
        self.metrics.counter("serve.requests_submitted").inc()
        self.metrics.gauge("serve.queue_depth").set(len(self._queue))
        return rid

    def _admit(self) -> int:
        """Fill every free slot from the queue; returns the number of
        requests that completed during admission (max_new = 1 or an
        immediate eos retires the slot at once and it is re-offered in
        the same pass)."""
        if self.paged:
            return self._admit_paged()
        completed = 0
        slot = 0
        while slot < self.n_slots:
            if self.req_of_slot[slot] is not None or not self._queue:
                slot += 1
                continue
            rid, req = self._queue.pop(0)
            t_sub = self._submit_ts.pop(rid, None)
            now = time.perf_counter()
            if t_sub is not None:
                self.metrics.histogram("serve.queue_wait_usec").observe(
                    (now - t_sub) * 1e6)
            plen = len(req.prompt)
            head = min(plen, self.buckets[-1])
            bucket = _bucket(head, self.buckets)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :head] = req.prompt[:head]
            row, first = self._prefill(padded, head)
            off = head
            while off < plen:
                n = min(self._chunk_w, plen - off)
                toks = np.zeros((1, self._chunk_w), np.int32)
                toks[0, :n] = req.prompt[off:off + n]
                first = self._extend(row, toks, off, n)
                off += n
            self._scatter(row, slot)
            first = int(first.cpu().reshape(-1)[0])
            if t_sub is not None:
                self.metrics.histogram("serve.ttft_usec").observe(
                    (time.perf_counter() - t_sub) * 1e6)
            self.metrics.counter("serve.tokens_out").inc()
            self.metrics.gauge("serve.queue_depth").set(len(self._queue))
            self.req_of_slot[slot] = rid
            self._out[rid] = [first]
            self.pos[slot] = plen
            self.last_tok[slot] = first
            self.budget[slot] = req.max_new - 1
            if req.eos_id is not None and first == req.eos_id:
                self.budget[slot] = 0
            self._retire_if_done(slot)
            if self.req_of_slot[slot] is None:
                completed += 1  # retired at admission: re-offer the slot
            else:
                slot += 1
        return completed

    # ---- paged admission / chunked prefill -----------------------------
    def _try_map(self, slot: int, req: Request) -> bool:
        """Reserve and map every page the request will ever touch
        (positions 0..plen+max_new-1) into the slot's table row:
        trie-shared leading pages are retained in place, the one shared
        page the request must write into is copied first, the rest come
        fresh off the free list. A mapped request can never stall
        mid-decode on an empty pool. Returns False (nothing mapped) when
        the pool cannot cover it even after trie eviction."""
        ps = self.page_size
        plen = len(req.prompt)
        need_pages = -(-(plen + req.max_new) // ps)
        shared: List[int] = []
        covered = 0
        if self.trie is not None:
            shared, covered = self.trie.match(req.prompt)
        # always recompute at least the last prompt token (the first
        # generated token needs its logits; the cache alone has none)
        prefill_from = min(covered, plen - 1)
        n_keep = min(len(shared), prefill_from // ps)
        n_new = need_pages - n_keep       # copies + fresh pages
        # pin every matched page across the eviction call: unretained
        # refcount-1 trie pages are exactly what evict() frees
        for p in shared:
            self.allocator.retain(p)
        if not self.allocator.can_alloc(n_new):
            if self.trie is not None:
                ev = self.trie.evict(self.allocator,
                                     n_new - self.allocator.free_pages)
                if ev:
                    self.metrics.counter("serve.trie_evictions").inc(ev)
            if not self.allocator.can_alloc(n_new):
                for p in shared:
                    self.allocator.release(p)
                return False
        pages: List[int] = list(shared[:n_keep])
        for src in shared[n_keep:]:
            dst = self.allocator.alloc()
            copy_page(self.pools, src, dst)
            self.allocator.release(src)   # drop the copy's pin
            pages.append(dst)
            self.metrics.counter("serve.cow_copies").inc()
        for _ in range(need_pages - len(pages)):
            pages.append(self.allocator.alloc())
        self.table[slot, :] = 0
        self.table[slot, :need_pages] = pages
        self._slot_pages[slot] = pages
        if covered > 0:
            self.metrics.counter("serve.prefix_hits").inc()
            self.metrics.counter("serve.prefix_tokens_shared").inc(
                prefill_from)
        self._prefilling[slot] = {"req": req, "next": prefill_from,
                                  "plen": plen}
        return True

    def _release_slot_pages(self, slot: int) -> None:
        for p in self._slot_pages[slot]:
            self.allocator.release(p)
        self._slot_pages[slot] = []
        self.table[slot, :] = 0
        self.active[slot] = False
        self._prefilling.pop(slot, None)

    def _admit_paged(self) -> int:
        """Paged admission plus the chunked-prefill tick. Head-of-line
        FIFO: when the queue head cannot reserve its pages the whole
        admission stalls (decode rounds keep draining, retirements free
        pages, the head admits next round)."""
        for slot in range(self.n_slots):
            if self.req_of_slot[slot] is not None or not self._queue:
                continue
            rid, req = self._queue[0]
            if not self._try_map(slot, req):
                self.metrics.counter("serve.admission_stalls").inc()
                break
            self._queue.pop(0)
            t_sub = self._submit_ts.pop(rid, None)
            if t_sub is not None:
                self.metrics.histogram("serve.queue_wait_usec").observe(
                    (time.perf_counter() - t_sub) * 1e6)
            self.metrics.gauge("serve.queue_depth").set(len(self._queue))
            self.req_of_slot[slot] = rid
            self._out[rid] = []
        completed, _ = self._prefill_tick()
        self._page_gauges()
        return completed

    def _prefill_tick(self) -> Tuple[int, bool]:
        """Advance every prefilling slot by up to ``prefill_budget``
        prompt tokens (None: finish it now) in page-aligned chunks.
        Returns (requests completed at prefill time, any progress)."""
        completed = 0
        progressed = False
        ps = self.page_size
        for slot in list(self._prefilling):
            st = self._prefilling[slot]
            req, plen = st["req"], st["plen"]
            budget = (plen if self.prefill_budget is None
                      else self.prefill_budget)
            logits = None
            while st["next"] < plen and budget > 0:
                a = st["next"]
                end = min(plen, (a // ps + 1) * ps, a + budget)
                n = end - a
                toks = np.zeros((1, ps), np.int32)
                toks[0, :n] = req.prompt[a:end]
                t_chunk = (time.perf_counter()
                           if self.spans is not None else 0.0)
                logits, _ = paged_prefill_chunk(
                    self.params, torch.as_tensor(toks, device=self.device),
                    a, n, self.pools,
                    torch.as_tensor(self.table[slot:slot + 1],
                                    device=self.device), self.cfg)
                st["next"] = end
                budget -= n
                progressed = True
                self.metrics.counter("serve.prefill_chunks").inc()
                if self.spans is not None:
                    self._span(self.req_of_slot[slot], STAGE_PREFILL_CHUNK,
                               t_chunk, time.perf_counter())
            if st["next"] < plen:
                continue  # budget spent; more chunks next round
            # prefill complete: seed the first token, open decoding
            first = int(torch.argmax(logits, dim=-1).cpu().reshape(-1)[0])
            rid = self.req_of_slot[slot]
            t_sub = self._accept_ts.get(rid)
            if t_sub is not None:
                self.metrics.histogram("serve.ttft_usec").observe(
                    (time.perf_counter() - t_sub) * 1e6)
            self.metrics.counter("serve.tokens_out").inc()
            self._out[rid] = [first]
            self.pos[slot] = plen
            self.last_tok[slot] = first
            self.budget[slot] = req.max_new - 1
            if req.eos_id is not None and first == req.eos_id:
                self.budget[slot] = 0
            self.active[slot] = True
            del self._prefilling[slot]
            if self.trie is not None:
                self.trie.register(req.prompt, plen, self.table[slot],
                                   self.allocator)
            self._retire_if_done(slot)
            if self.req_of_slot[slot] is None:
                completed += 1
        return completed, progressed

    def _page_gauges(self) -> None:
        self.metrics.gauge("serve.pages_in_use").set(
            self.allocator.pages_in_use)
        self.metrics.gauge("serve.pages_free").set(
            self.allocator.free_pages)

    def _span(self, rid: Optional[int], stage: int, t0: float,
              t1: float) -> None:
        """Emit a scheduler-stage span for server rid ``rid`` when a
        recorder is attached and the fabric-level request is sampled."""
        if rid is None or self.span_rid_of is None:
            return
        frid = self.span_rid_of(rid)
        if frid is not None and self.spans.sampled(frid):
            self.spans.emit(frid, stage, t0, t1)

    def _retire_if_done(self, slot: int):
        rid = self.req_of_slot[slot]
        if rid is None or self.budget[slot] > 0:
            return
        self.req_of_slot[slot] = None
        if self.paged:
            self._release_slot_pages(slot)
        self.metrics.counter("serve.requests_completed").inc()
        self._completed_log.append(
            (rid, np.asarray(self._out[rid], np.int32)))
        t_sub = self._accept_ts.pop(rid, None)
        if t_sub is not None:
            self.metrics.histogram("serve.e2e_usec").observe(
                (time.perf_counter() - t_sub) * 1e6)

    # ---- fabric-facing hooks ------------------------------------------
    def poll_completed(self) -> List[Tuple[int, np.ndarray]]:
        """Drain the (rid, tokens) pairs completed since the last poll."""
        out, self._completed_log = self._completed_log, []
        return out

    def cancel(self, rid: int) -> bool:
        """Withdraw a request: de-queue it, or free its slot mid-decode.
        False when the rid is unknown or already completed; a canceled
        request's ``run()`` output is its partial prefix."""
        if not 0 <= rid < len(self._out) or rid in self._canceled:
            return False
        for i, (qrid, _) in enumerate(self._queue):
            if qrid == rid:
                del self._queue[i]
                self._canceled.add(rid)
                self._submit_ts.pop(rid, None)
                self._accept_ts.pop(rid, None)
                self.metrics.counter("serve.requests_canceled").inc()
                self.metrics.gauge("serve.queue_depth").set(
                    len(self._queue))
                return True
        for slot in range(self.n_slots):
            if self.req_of_slot[slot] == rid:
                self.req_of_slot[slot] = None
                self.budget[slot] = 0
                if self.paged:
                    self._release_slot_pages(slot)
                self._canceled.add(rid)
                self._accept_ts.pop(rid, None)
                self.metrics.counter("serve.requests_canceled").inc()
                return True
        return False

    def has_work(self) -> bool:
        """Queued or in-flight requests remain."""
        return bool(self._queue) or any(
            r is not None for r in self.req_of_slot)

    def free_slots(self) -> int:
        return sum(1 for r in self.req_of_slot if r is None)

    def queue_depth(self) -> int:
        return len(self._queue)

    def slot_ownership(self) -> Tuple[Optional[int], ...]:
        """Which rid occupies each slot (None = free)."""
        return tuple(self.req_of_slot)

    # ---- the decode loop ------------------------------------------------
    def step_round(self):
        """Admit pending requests, run one round of ``round_len`` ragged
        decode steps (clipped to the shortest active budget under
        ``clip_rounds``), distribute the tokens."""
        if self.paged:
            return self._step_round_paged()
        completed = self._admit()
        if all(r is None for r in self.req_of_slot):
            return completed > 0
        active = sum(1 for r in self.req_of_slot if r is not None)
        kk = self.round_len
        if self.clip_rounds:
            kk = max(1, min(kk, int(min(
                self.budget[s] for s in range(self.n_slots)
                if self.req_of_slot[s] is not None))))
        t0 = time.perf_counter()
        tok, pos, toks = self._round(self.last_tok, self.pos, kk)
        toks = toks.cpu().numpy()
        self.last_tok = tok.cpu().numpy().copy()
        self.pos = pos.cpu().numpy().copy()
        dt = time.perf_counter() - t0  # tokens on the host: round done
        self._observe_round(dt, kk, active)
        self._distribute(toks, kk)
        return True

    def _step_round_paged(self):
        """The paged round: admission and the chunked-prefill tick, then
        a budget-clipped decode round over the active slots, then token
        distribution and page release."""
        completed = self._admit()
        if not self.active.any():
            return completed > 0 or bool(self._prefilling)
        active_slots = [s for s in range(self.n_slots) if self.active[s]]
        kk = self.round_len
        if self.clip_rounds:
            kk = max(1, min(kk, int(min(self.budget[s]
                                        for s in active_slots))))
        t0 = time.perf_counter()
        tok, pos, toks = self._round_paged(kk)
        toks = toks.cpu().numpy()
        self.last_tok = tok.cpu().numpy().copy()
        self.pos = pos.cpu().numpy().copy()
        dt = time.perf_counter() - t0
        self._observe_round(dt, kk, len(active_slots))
        self._distribute(toks, kk, only_active=True)
        self._page_gauges()
        return True

    def _observe_round(self, dt: float, kk: int, active: int) -> None:
        self.metrics.histogram("serve.round_usec").observe(dt * 1e6)
        self.metrics.histogram("serve.tok_usec").observe(dt * 1e6 / kk)
        self.metrics.histogram("serve.occupancy_pct").observe(
            100.0 * active / self.n_slots)
        self.metrics.counter("serve.rounds").inc()
        self.metrics.counter("serve.steps").inc(kk)
        self.rounds_run += 1
        self.steps_run += kk

    def _distribute(self, toks, kk: int,
                    only_active: bool = False) -> None:
        tokens_out = self.metrics.counter("serve.tokens_out")
        for slot in range(self.n_slots):
            rid = self.req_of_slot[slot]
            if rid is None:
                continue
            if only_active and not self.active[slot]:
                continue  # mid-prefill: nothing decoded this round
            take = int(min(self.budget[slot], kk))
            seq = toks[slot, :take].tolist()
            eos = self._eos[rid]
            if eos is not None and eos in seq:
                seq = seq[:seq.index(eos) + 1]
                self.budget[slot] = 0
            else:
                self.budget[slot] -= take
            self._out[rid].extend(seq)
            tokens_out.inc(len(seq))
            self._retire_if_done(slot)

    def run(self) -> List[np.ndarray]:
        """Drive rounds until every submitted request completes."""
        while self._queue or any(r is not None for r in self.req_of_slot):
            progressed = self.step_round()
            if not progressed and self._queue:  # pragma: no cover
                raise RuntimeError("queue stuck with no free slots")
        return [np.asarray(o if o is not None else [], np.int32)
                for o in self._out]

    def stats(self) -> dict:
        """Serving-telemetry snapshot: counters and gauges verbatim,
        histograms as percentile summaries (count/mean/min/max +
        p50/p90/p99 from the log2 buckets). Paged servers add the
        allocator's own counters under ``pages``."""
        snap = self.metrics.snapshot()
        snap["histograms"] = {k: hist_summary(h)
                              for k, h in snap["histograms"].items()}
        if self.paged:
            snap["pages"] = self.allocator.stats()
            if self.trie is not None:
                snap["pages"]["trie_entries"] = self.trie.entries
        return snap
