"""The serving fabric's decode-backend face over the port's DecodeServer.

The port of ``ModelBackend`` from ``rlo_tpu/serving/backend.py``. The
fabric (``DecodeFabric``) is generic over the thing that decodes: any
object with the slot-server face

    submit(key, prompt, max_new, eos_id=None) -> None
    step_round() -> [(key, tokens_tuple), ...]   # newly completed
    cancel(key) -> bool
    has_work() -> bool
    load() -> (free_slots, queue_depth)
    active_keys() -> [key, ...]                  # keys holding a slot
    attach_spans(recorder) -> None
    stats() -> dict

``ModelBackend`` puts ``rlo_tpu_torch.models.serve.DecodeServer`` (dense
or paged) behind it: fabric request keys map to server rids, completions
drain through the server's ``poll_completed()``, and an ownership move
becomes ``cancel()`` (the re-queued request restarts from its prompt on
the new owner; greedy decode over replicated weights makes the re-decode
token-identical). The model-free stub backends are simulator parts and
stay with the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


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
