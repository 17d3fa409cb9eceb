"""Decode backends for the serving fabric (docs/DESIGN.md §11).

The port's own copy of ``rlo_tpu/serving/backend.py``. The fabric
(``DecodeFabric``) is generic over the thing that decodes: any object
with the slot-server face

    submit(key, prompt, max_new, eos_id=None) -> None
    step_round() -> [(key, tokens_tuple), ...]   # newly completed
    cancel(key) -> bool
    has_work() -> bool
    load() -> (free_slots, queue_depth)
    active_keys() -> [key, ...]                  # keys holding a slot
    attach_spans(recorder) -> None               # optional
    stats() -> dict

``active_keys`` is the queue->active boundary the fabric's latency
attribution reads (docs/DESIGN.md §19): a key that appears there (or
completes) for the first time after a ``step_round()`` has just ended
its queue residency.

Three implementations:

  - ``ModelBackend`` puts ``rlo_tpu_torch.models.serve.DecodeServer``
    (dense or paged) behind it: fabric request keys map to server rids,
    completions drain through the server's ``poll_completed()``, and an
    ownership move becomes ``cancel()`` (the re-queued request restarts
    from its prompt on the new owner; greedy decode over replicated
    weights makes the re-decode token-identical). This is the face that
    puts a fleet of decode ranks on the card.
  - ``StubBackend`` is the deterministic, model-free twin the simulator
    scenarios run: tokens are a pure function of the prompt (a crc32
    chain), the property a replicated-weights fleet has under greedy
    decoding, so the exactly-once-with-identical-tokens property is
    seed-checkable without a model.
  - ``PagedStubBackend`` adds the paged server's page accounting
    (``serving/pages.py``) to the stub.

The stubs are line-for-line copies of the JAX package's
(``tests/test_torch_fabric.py`` holds them equal).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def stub_tokens(prompt: Sequence[int], max_new: int,
                eos_id: Optional[int] = None,
                vocab: int = 32768) -> Tuple[int, ...]:
    """The stub model's greedy decode: a crc32 chain seeded by the
    prompt. Deterministic in the prompt alone — independent of which
    rank decodes, of batching, and of restarts — mirroring greedy
    decode over replicated weights."""
    prompt = tuple(int(t) for t in prompt)
    state = zlib.crc32(struct.pack(f"<{len(prompt)}i", *prompt))
    out: List[int] = []
    for i in range(max_new):
        state = zlib.crc32(struct.pack("<i", i), state)
        tok = state % vocab
        out.append(tok)
        if eos_id is not None and tok == eos_id:
            break
    return tuple(out)


class StubBackend:
    """Slot-pool scheduler with the stub model: ``n_slots`` concurrent
    requests, ``round_len`` tokens per request per ``step_round()``,
    FIFO admission from the queue — the same scheduling shape as
    ``DecodeServer`` with the jit replaced by ``stub_tokens``."""

    def __init__(self, n_slots: int = 4, round_len: int = 8,
                 vocab: int = 32768):
        self.n_slots = n_slots
        self.round_len = round_len
        self.vocab = vocab
        self._queue: List = []         # keys awaiting a slot
        self._req: Dict = {}           # key -> (tokens, emitted_count)
        self._active: List = []        # keys holding a slot
        self.rounds_run = 0
        self.tokens_out = 0

    def submit(self, key, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None) -> None:
        if key in self._req:
            return
        self._req[key] = [stub_tokens(prompt, max_new, eos_id,
                                      self.vocab), 0]
        self._queue.append(key)

    def cancel(self, key) -> bool:
        if key not in self._req:
            return False
        del self._req[key]
        if key in self._queue:
            self._queue.remove(key)
        if key in self._active:
            self._active.remove(key)
        return True

    def step_round(self) -> List[Tuple[object, Tuple[int, ...]]]:
        while self._queue and len(self._active) < self.n_slots:
            self._active.append(self._queue.pop(0))
        done: List[Tuple[object, Tuple[int, ...]]] = []
        for key in list(self._active):
            toks, emitted = self._req[key]
            emitted = min(emitted + self.round_len, len(toks))
            self.tokens_out += emitted - self._req[key][1]
            self._req[key][1] = emitted
            if emitted >= len(toks):
                done.append((key, toks))
                self._active.remove(key)
                del self._req[key]
        self.rounds_run += 1
        return done

    def has_work(self) -> bool:
        return bool(self._req)

    def load(self) -> Tuple[int, int]:
        return (self.n_slots - len(self._active), len(self._queue))

    def active_keys(self) -> List:
        return list(self._active)

    def stats(self) -> dict:
        return {"backend": "stub", "n_slots": self.n_slots,
                "round_len": self.round_len,
                "rounds_run": self.rounds_run,
                "tokens_out": self.tokens_out,
                "active": len(self._active),
                "queued": len(self._queue)}


class PagedStubBackend(StubBackend):
    """The paged server's page-accounting twin over the stub model
    (docs/DESIGN.md §12): the SAME crc-chain tokens and slot
    scheduling as StubBackend, plus the real ``PageAllocator`` /
    ``PrefixTrie`` bookkeeping the paged ``DecodeServer`` runs —
    admission reserves ceil((plen+max_new)/page_size) pages (minus
    trie-shared prefix pages, COW-splitting the written one),
    head-of-line backpressure when the pool is dry, completion
    releases pages and registers the prompt's prefix. No device
    arrays move, so fabric scenarios can exercise allocator churn,
    prefix reuse, COW and eviction seed-deterministically."""

    def __init__(self, n_slots: int = 4, round_len: int = 8,
                 vocab: int = 32768, n_pages: int = 33,
                 page_size: int = 8):
        from rlo_tpu_torch.serving.pages import PageAllocator, PrefixTrie
        super().__init__(n_slots=n_slots, round_len=round_len,
                         vocab=vocab)
        self.alloc = PageAllocator(n_pages, page_size)
        self.trie = PrefixTrie(page_size)
        self._meta: Dict = {}    # key -> (prompt tuple, max_new)
        self._pages: Dict = {}   # key -> owned pages, table order
        self.prefix_hits = 0
        self.cow_copies = 0
        self.stalls = 0
        self.evictions = 0

    def submit(self, key, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None) -> None:
        if key in self._req:
            return
        super().submit(key, prompt, max_new, eos_id)
        self._meta[key] = (tuple(int(t) for t in prompt), max_new)

    def _reserve(self, key) -> bool:
        """The stub twin of DecodeServer._try_map: trie match, COW the
        written shared page, fresh pages for the rest; False (nothing
        held) under pool pressure even after eviction."""
        prompt, max_new = self._meta[key]
        ps = self.alloc.page_size
        plen = len(prompt)
        need = -(-(plen + max_new) // ps)
        shared, covered = self.trie.match(prompt)
        prefill_from = min(covered, plen - 1)
        n_keep = min(len(shared), prefill_from // ps)
        n_new = need - n_keep
        for p in shared:
            self.alloc.retain(p)
        if not self.alloc.can_alloc(n_new):
            self.evictions += self.trie.evict(
                self.alloc, n_new - self.alloc.free_pages)
            if not self.alloc.can_alloc(n_new):
                for p in shared:
                    self.alloc.release(p)
                return False
        pages = list(shared[:n_keep])
        for src in shared[n_keep:]:
            pages.append(self.alloc.alloc())   # the COW copy
            self.alloc.release(src)
            self.cow_copies += 1
        while len(pages) < need:
            pages.append(self.alloc.alloc())
        self._pages[key] = pages
        if covered > 0:
            self.prefix_hits += 1
        return True

    def _release(self, key) -> None:
        for p in self._pages.pop(key, ()):
            self.alloc.release(p)
        self._meta.pop(key, None)

    def cancel(self, key) -> bool:
        ok = super().cancel(key)
        if ok:
            self._release(key)
        else:
            self._meta.pop(key, None)
        return ok

    def step_round(self) -> List[Tuple[object, Tuple[int, ...]]]:
        # paged admission: FIFO with head-of-line backpressure, the
        # paged DecodeServer's discipline — then the stock decode round
        admitted: List = []
        while self._queue and len(self._active) + len(admitted) \
                < self.n_slots:
            key = self._queue[0]
            if not self._reserve(key):
                self.stalls += 1
                break
            admitted.append(self._queue.pop(0))
        # the parent round must admit exactly the RESERVED keys: park
        # the backpressured tail out of its reach for the round
        tail, self._queue = self._queue, admitted
        done = super().step_round()
        self._queue.extend(tail)
        for key, _toks in done:
            prompt, _ = self._meta.get(key, ((), 0))
            if prompt and key in self._pages:
                self.trie.register(prompt, len(prompt),
                                   self._pages[key], self.alloc)
            self._release(key)
        return done

    def has_work(self) -> bool:
        return bool(self._req)

    def stats(self) -> dict:
        base = super().stats()
        base.update(backend="paged_stub",
                    pages=self.alloc.stats(),
                    trie_entries=self.trie.entries,
                    prefix_hits=self.prefix_hits,
                    cow_copies=self.cow_copies,
                    stalls=self.stalls,
                    evictions=self.evictions)
        return base


class ModelBackend:
    """The continuous-batching ``DecodeServer`` behind the backend
    face."""

    def __init__(self, server):
        self.server = server
        self._rid_of: Dict = {}   # fabric key -> server rid
        self._key_of: Dict = {}   # server rid -> fabric key

    def submit(self, key, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None) -> None:
        if key in self._rid_of:
            return
        rid = self.server.submit(np.asarray(list(prompt), np.int32),
                                 max_new, eos_id=eos_id)
        self._rid_of[key] = rid
        self._key_of[rid] = key

    def cancel(self, key) -> bool:
        rid = self._rid_of.pop(key, None)
        if rid is None:
            return False
        self._key_of.pop(rid, None)
        return self.server.cancel(rid)

    def step_round(self) -> List[Tuple[object, Tuple[int, ...]]]:
        if self.server.has_work():
            self.server.step_round()
        out = []
        for rid, toks in self.server.poll_completed():
            key = self._key_of.pop(rid, None)
            if key is None:
                continue  # canceled while the round ran
            self._rid_of.pop(key, None)
            out.append((key, tuple(int(t) for t in toks)))
        return out

    def has_work(self) -> bool:
        return self.server.has_work()

    def load(self) -> Tuple[int, int]:
        return (self.server.free_slots(), self.server.queue_depth())

    def active_keys(self) -> List:
        return [self._key_of[r] for r in self.server.req_of_slot
                if r is not None and r in self._key_of]

    def attach_spans(self, recorder) -> None:
        """Hand the server's paged scheduler the fabric's span recorder,
        so it emits prefill-chunk spans under fabric request ids."""
        self.server.spans = recorder
        self.server.span_rid_of = self._key_of.get

    def stats(self) -> dict:
        return {"backend": "decode_server", **self.server.stats()}
