"""Continuous batching: a persistent decode loop with slot admission.

The port of ``rlo_tpu/models/serve.py``'s ``DecodeServer`` in its dense
mode. A fixed pool of ``n_slots`` batch rows decodes in rounds of
``round_len`` ragged decode steps; a finished row's slot is refilled by
the next queued request without restarting the batch. Admission
prefills a fresh request at a padded prompt bucket into a one-row cache
(K2 attends the prompt), extends prompts longer than the largest bucket
with ``block_decode`` chunks (K8 writes, K6 attends), and copies the
row into its slot in place. A round is a Python loop of
``decode_step``s (K7 writes, K6 attends) with the greedy pick on the
device; the host reads the round's tokens once at its end.

Finished rows keep decoding masked garbage until the round ends;
outputs are truncated to each request's ``max_new``, and slot reuse is
safe because every attend masks at the row's own position and cache
writes overwrite in order (a retired slot's position runs past max_len,
where K7 drops the write).

The telemetry names are the JAX package's (``serve.ttft_usec``,
``serve.queue_wait_usec``, ``serve.e2e_usec``, ``serve.round_usec``,
``serve.tok_usec``, ``serve.occupancy_pct``, the request/token counters
and the ``serve.queue_depth`` gauge), recorded into the port's
``SERVING`` registry unless the server is handed its own.

Paged mode (K9-K11) and the span-tracing hooks come with later slices of
the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rlo_tpu_torch.models.generate import (block_decode, decode_step,
                                           init_kv_cache, prefill)
from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                              _dense_only, cast_params)
from rlo_tpu_torch.utils.metrics import SERVING, Registry, hist_summary


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
    """Continuous-batching server over ``n_slots`` rows of one dense
    KV cache on the params' device.

    submit() queues requests; run() drives rounds until every request
    completes and returns the per-request token arrays in submission
    order; step_round() is one admission pass plus one decode round.
    """

    def __init__(self, params, cfg: TransformerConfig, *,
                 n_slots: int, max_len: int, round_len: int = 32,
                 prompt_buckets: Tuple[int, ...] = (64, 256, 1024),
                 metrics: Optional[Registry] = None,
                 paged: bool = False):
        if paged:
            raise NotImplementedError(
                "paged mode is not ported yet: it comes with the paged "
                "serving slice of the port (kernels K9-K11)")
        _dense_only(cfg)
        self.metrics = SERVING if metrics is None else metrics
        self.params = cast_params(params, cfg.act_dtype)
        self.device = self.params["embed"].device
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.round_len = round_len
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
                                    self.cfg)
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

    # ---- request lifecycle --------------------------------------------
    def submit(self, prompt, max_new: int,
               eos_id: Optional[int] = None) -> int:
        """Queue a request; returns its id (position in results). Any
        prompt with plen + max_new <= max_len is admissible."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_len {self.max_len}")
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

    def _retire_if_done(self, slot: int):
        rid = self.req_of_slot[slot]
        if rid is None or self.budget[slot] > 0:
            return
        self.req_of_slot[slot] = None
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
        decode steps, distribute the tokens."""
        completed = self._admit()
        if all(r is None for r in self.req_of_slot):
            return completed > 0
        active = sum(1 for r in self.req_of_slot if r is not None)
        kk = self.round_len
        t0 = time.perf_counter()
        tok, pos, toks = self._round(self.last_tok, self.pos, kk)
        toks = toks.cpu().numpy()
        self.last_tok = tok.cpu().numpy().copy()
        self.pos = pos.cpu().numpy().copy()
        dt = time.perf_counter() - t0  # tokens on the host: round done
        self._observe_round(dt, kk, active)
        self._distribute(toks, kk)
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

    def _distribute(self, toks, kk: int) -> None:
        tokens_out = self.metrics.counter("serve.tokens_out")
        for slot in range(self.n_slots):
            rid = self.req_of_slot[slot]
            if rid is None:
                continue
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
        p50/p90/p99 from the log2 buckets)."""
        snap = self.metrics.snapshot()
        snap["histograms"] = {k: hist_summary(h)
                              for k, h in snap["histograms"].items()}
        return snap
