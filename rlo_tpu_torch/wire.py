"""Message types and wire format.

The port's own copy of ``rlo_tpu/wire.py``; frames are byte-identical
to the JAX package's (``tests/test_torch_engine.py``).

Reference parity: the PBuf layout (`rootless_ops.c:64-73,
1369-1410`) is ``[origin:int][pid:int][vote:int][data_len:size_t][data]`` —
a 4-byte origin prefix written by RLO_msg_new_bc (rootless_ops.c:307) followed
by the serialized proposal buffer. We keep the same logical fields in one
little-endian header and send **variable-size frames** — the reference always
ships the full 32 KB buffer regardless of payload (rootless_ops.c:1588), a
known perf flaw SURVEY.md §7 says not to replicate.

The ``vote`` field doubles as a type discriminator in the reference
(0/1 vote, -1 proposal, -2 decision — rootless_ops.h:88); here message kind
travels out-of-band as the transport tag (mirroring MPI_TAG dispatch in
make_progress_gen, rootless_ops.c:582-621), and ``vote`` only carries votes
and decisions.

``seq`` is the reliable-delivery layer's per-(sender, receiver) link
sequence number (net-new: the reference has no loss recovery at all,
SURVEY.md §5). It is stamped by the sending engine's ARQ machinery at
isend time — NOT by the application — and is -1 on frames outside the
ARQ path (heartbeats, ACKs, engines without ARQ enabled). Receivers
dedup on (immediate sender, seq) before any tag dispatch, which makes
retransmits idempotent even through the store-and-forward broadcast
path; cumulative acknowledgements travel back as ``Tag.ACK`` frames
(and piggybacked on heartbeats) carrying the highest-contiguous
received seq in the ``vote`` field.

``epoch`` is the membership subsystem's link-level view stamp
(docs/DESIGN.md §8): the sending engine stamps its current membership
epoch into every frame at transmission time (retransmits are restamped
with the CURRENT epoch — the seq, not the epoch, is the frame's
identity). Receivers quarantine frames from senders they consider
failed, and frames whose epoch is below the per-sender floor set when
that sender was last declared failed or readmitted — this is what
makes stale frames from a "dead" peer distinguishable from its
post-rejoin traffic. ``Tag.JOIN`` / ``Tag.JOIN_WELCOME`` are exempt
(they are the frames that cross membership boundaries to heal them).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from rlo_tpu_torch.utils.metrics import ENGINE_COUNTER_KEYS


class Tag(enum.IntEnum):
    """Transport-level message tags (reference RLO_COMM_TAGS,
    rootless_ops.h:50-61). Values 0-8 match the reference enum order;
    DATA/BARRIER are net-new for the data-carrying collectives.

    Values are paired with the C ``enum rlo_tag`` (rlo_core.h) and
    checked by rlo-lint R1. Members without their own branch in the
    engine dispatch are delivered through the ``_on_other`` catch-all
    and carry the ``rlo-lint: default-route`` annotation (R4)."""
    BCAST = 0
    JOB_DONE = 1      # rlo-lint: default-route
    IAR_PROPOSAL = 2
    IAR_VOTE = 3
    IAR_DECISION = 4
    BC_TEARDOWN = 5   # rlo-lint: default-route
    IAR_TEARDOWN = 6  # rlo-lint: default-route
    P2P = 7           # rlo-lint: default-route
    SYS = 8           # rlo-lint: default-route
    DATA = 9          # rlo-lint: default-route
    BARRIER = 10      # rlo-lint: default-route
    HEARTBEAT = 11   # point-to-point ring liveness probe (net-new)
    FAILURE = 12     # rootless failure notification; pid = failed rank
    ACK = 13         # cumulative link ACK; vote = highest contiguous seq
    ABORT = 14       # rootless op-abort notification (deadline expiry);
                     # pid = aborted pid, payload = round generation
    JOIN = 15        # membership probe/petition; payload = 5 x le32
                     # (incarnation, epoch, min-alive-rank, petition,
                     # member) of the sender's view — petition=1 marks
                     # a joiner's plea vs a survivor's heal probe;
                     # member=1 tells the DESTINATION it is alive in
                     # the sender's view, steering a losing-view
                     # receiver to a Tag.MSYNC catch-up instead of a
                     # full rejoin (old 4-field probes parse member=0)
    JOIN_WELCOME = 16  # admission notice from the admitting proposer:
                     # payload = (epoch, incarnation echo, member list);
                     # followed by a point-to-point replay of the
                     # recent-broadcast log
    SERVE = 17       # rlo-lint: default-route
                     # serving-fabric point-to-point frame (load
                     # reports, docs/DESIGN.md §11): reliable (ARQ-
                     # stamped), epoch-gated, delivered via pickup —
                     # the payload is a fabric record, not engine state
    TELEM = 18       # rlo-lint: default-route
                     # in-band telemetry digest (docs/DESIGN.md §17):
                     # reliable (ARQ-stamped), epoch-gated, delivered
                     # via pickup to the telemetry plane
                     # (rlo_tpu/observe/), which store-and-forwards it
                     # along the broadcast overlay — the payload is a
                     # delta-encoded digest (encode_telem below), not
                     # engine state
    MSYNC = 19       # membership view-state sync (docs/DESIGN.md §18):
                     # a kind byte discriminates REQ (epoch-lagging
                     # member asks an up-to-date peer for its view),
                     # RSP (epoch + member admission records + a
                     # recent-log advert), AD (view-change re-flood
                     # advert: log-entry identities, not payloads) and
                     # WANT (the advert entries the receiver provably
                     # misses). ARQ- and epoch-exempt like JOIN: it
                     # crosses the membership boundaries it heals, and
                     # REQs repeat at join_interval until answered


#: Tags that are store-and-forward broadcast over the skip-ring overlay.
BCAST_TAGS = frozenset({Tag.BCAST, Tag.IAR_PROPOSAL, Tag.IAR_DECISION,
                        Tag.FAILURE, Tag.ABORT})

#: Tags the ARQ layer neither stamps nor retransmits: heartbeats are
#: periodic by construction (a lost one is replaced by the next) and
#: ACKs ack themselves by effect (a lost ACK just triggers one more
#: retransmit, which the dedup layer absorbs and re-acks). JOIN probes
#: repeat at their own cadence until answered, and a lost WELCOME is
#: replaced when the joiner's next probe arrives — both must also work
#: across the membership boundary where ARQ link state is being reset.
#: MSYNC shares the JOIN rationale: sync REQs repeat at join_interval
#: until the view catches up, and an ARQ-stamped frame into a
#: quarantining receiver would never be acked (a retransmit-then-give-
#: up loop that itself declares failures).
ARQ_EXEMPT_TAGS = frozenset({Tag.HEARTBEAT, Tag.ACK, Tag.JOIN,
                             Tag.JOIN_WELCOME, Tag.MSYNC})

#: Tags exempt from the stale-epoch quarantine: the membership frames
#: themselves must cross partition/incarnation boundaries to heal them.
EPOCH_EXEMPT_TAGS = frozenset({Tag.JOIN, Tag.JOIN_WELCOME, Tag.MSYNC})

# origin, pid, vote, seq, epoch, data_len
# rlo-lint: paired-with rlo_core.h:RLO_HEADER_SIZE
_HEADER = struct.Struct("<iiiiiQ")
HEADER_SIZE = _HEADER.size
#: byte offset of the seq field — the ARQ send path re-stamps encoded
#: frames in place (one encode per broadcast, one patch per edge)
SEQ_OFFSET = 12  # rlo-lint: paired-with rlo_core.h:RLO_SEQ_OFFSET
#: byte offset of the epoch field — stamped by the engine send gate at
#: every transmission (including retransmits) with the CURRENT epoch
EPOCH_OFFSET = 16  # rlo-lint: paired-with rlo_core.h:RLO_EPOCH_OFFSET

#: Default engine cap, matching RLO_MSG_SIZE_MAX (rootless_ops.h:49). Frames
#: themselves are variable-size; this only bounds a single message payload.
MSG_SIZE_MAX = 32768  # rlo-lint: paired-with rlo_core.h:RLO_MSG_SIZE_MAX


@dataclass
class Frame:
    """One wire message. ``origin`` is the broadcast initiator (not the
    immediate sender — that is transport metadata, like MPI_SOURCE).
    ``seq`` is per-(immediate sender, receiver) link state owned by the
    ARQ layer and ``epoch`` is the sender's membership epoch at
    transmission time (stamped by the engine send gate); neither is an
    application field."""
    origin: int
    pid: int = -1
    vote: int = -1
    payload: bytes = b""
    seq: int = -1
    epoch: int = 0

    def encode(self) -> bytes:
        return _HEADER.pack(self.origin, self.pid, self.vote, self.seq,
                            self.epoch, len(self.payload)) + self.payload

    @classmethod
    def decode(cls, raw: bytes) -> "Frame":
        if len(raw) < HEADER_SIZE:
            raise ValueError(f"frame too short: {len(raw)} < {HEADER_SIZE}")
        origin, pid, vote, seq, epoch, n = _HEADER.unpack_from(raw)
        payload = bytes(raw[HEADER_SIZE:HEADER_SIZE + n])
        if len(payload) != n:
            raise ValueError(f"truncated frame: want {n} payload bytes, "
                             f"have {len(raw) - HEADER_SIZE}")
        return cls(origin, pid, vote, payload, seq, epoch)


def restamp_seq(raw: bytes, seq: int) -> bytes:
    """Return ``raw`` with its header seq field replaced — the ARQ send
    path's per-edge stamp (avoids re-encoding the payload per edge)."""
    buf = bytearray(raw)
    struct.pack_into("<i", buf, SEQ_OFFSET, seq)
    return bytes(buf)


def restamp_epoch(raw: bytes, epoch: int) -> bytes:
    """Return ``raw`` with its header epoch field replaced — the send
    gate's per-transmission membership stamp (re-flooded and
    retransmitted frames carry the CURRENT epoch, so a live sender's
    old traffic is never mistaken for a dead incarnation's). Returns
    ``raw`` itself when the stamp already matches (the common case —
    all link epochs 0 — never copies; mirror of the C send gate)."""
    # rlo-sentinel: trusted — send-path helper: `raw` is a frame THIS
    # engine just encoded (>= HEADER_SIZE by construction), not wire
    # input from a peer
    if struct.unpack_from("<i", raw, EPOCH_OFFSET)[0] == epoch:
        return raw
    buf = bytearray(raw)
    struct.pack_into("<i", buf, EPOCH_OFFSET, epoch)
    return bytes(buf)


def restamp_link(raw: bytes, seq: int, epoch: int) -> bytes:
    """One-copy combined seq + epoch stamp for the ARQ send path."""
    buf = bytearray(raw)
    struct.pack_into("<ii", buf, SEQ_OFFSET, seq, epoch)
    return bytes(buf)


# ---------------------------------------------------------------------------
# Telemetry digest codec (docs/DESIGN.md §17). One digest = one rank's
# compact, delta-encoded telemetry sample, carried in a Tag.TELEM
# frame payload and store-and-forwarded by the telemetry plane
# (rlo_tpu/observe/telemetry.py) so any rank converges on an
# eventually-consistent fleet view. The byte layout is PINNED so the C
# engine can originate byte-identical digests (rlo_wire.c
# rlo_telem_encode / rlo_engine.c rlo_engine_telem_digest; parity
# asserted by tests/test_observe.py):
#
#   offset 0   magic  "RLOT\x01"                      (5 bytes)
#   offset 5   flags  u8    bit0 = FULL snapshot (deltas vs zero)
#   offset 6   rank   i32le origin rank of the sample
#   offset 10  epoch  i32le origin's membership epoch at emit time
#   offset 14  seq    u32le per-origin digest sequence (0, 1, 2, ...)
#   offset 18  mask   u64le bit i set => TELEM_KEYS[i] delta present
#   offset 26  deltas       one unsigned LEB128 varint per set mask
#                           bit (ascending bit order), zigzag-encoded
#                           (value - previous emitted value; a FULL
#                           digest encodes the absolute values, i.e.
#                           deltas vs zero, with every bit set)
#
# Receivers apply a digest only when it is FULL or exactly one seq
# past the last applied one — a gap (lost delta) parks the rank's
# view entry as stale until the origin's next full snapshot heals it.
# ---------------------------------------------------------------------------

#: digest magic prefix (the Tag.TELEM payload discriminator)
# rlo-lint: paired-with rlo_core.h:RLO_TELEM_MAGIC
TELEM_MAGIC = b"RLOT\x01"

#: fixed header size before the varint delta section
# rlo-lint: paired-with rlo_core.h:RLO_TELEM_HEADER_SIZE
TELEM_HEADER_SIZE = 26

#: digest keys beyond the engine-counter schema: per-link rollups
#: (frames both ways, the worst ack-measured RTT EWMA in usec), live
#: queue depth and pickup backlog, the serving layer's paged-pool
#: occupancy, and the fabric latency block (in-flight requests plus
#: p50/p99 TTFT and e2e from the fabric's log2-bucket histograms —
#: docs/DESIGN.md §19). All serving keys are zero on ranks without an
#: attached fabric — the C engine always emits 0 here. The trailing
#: collective data-plane rollups (cumulative schedule steps executed
#: and payload bytes sent by the engine-substrate collectives —
#: docs/DESIGN.md §21) are likewise zero on the C engine: tensor
#: collectives are Python-side.
# rlo-lint: paired-with rlo_wire.c:k_telem_keys
TELEM_EXTRA_KEYS = (
    "tx_frames", "rx_frames", "rtt_ewma_max_usec",
    "q_wait", "pickup_backlog", "pages_in_use", "pages_free",
    "serve_inflight", "ttft_p50_usec", "ttft_p99_usec",
    "e2e_p50_usec", "e2e_p99_usec",
    "coll_steps", "coll_bytes",
    "remedies_proposed", "remedies_executed",
    "quarantined", "backpressure_level",
)

#: The full digest schema, in mask-bit order: the engine-counter
#: schema (so every rlo-lint R2-pinned counter rides the digest — the
#: heal-cost counters included) followed by the extras. Bounded at 64
#: keys by the u64 mask; rlo-lint R2 pins this tuple against the C
#: codec's key-name table (rlo_wire.c k_telem_keys).
TELEM_KEYS = ENGINE_COUNTER_KEYS + TELEM_EXTRA_KEYS
assert len(TELEM_KEYS) <= 64, "TELEM mask is a u64: at most 64 keys"

_TELEM_HDR = struct.Struct("<BiiIQ")  # flags, rank, epoch, seq, mask


def _zigzag(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


def _unzigzag(u: int) -> int:
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)


def _varint(out: bytearray, u: int) -> None:
    while u >= 0x80:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)


def encode_telem(rank: int, epoch: int, seq: int,
                 values: Sequence[int],
                 prev: Optional[Sequence[int]] = None,
                 full: bool = False) -> bytes:
    """Encode one telemetry digest. ``values`` are the CURRENT sample
    in TELEM_KEYS order; ``prev`` the previously EMITTED sample (the
    delta base). ``full`` (or ``prev=None``) emits a full snapshot —
    absolute values, every mask bit set — which is what heals a
    receiver that lost a delta."""
    if len(values) != len(TELEM_KEYS):
        raise ValueError(f"need {len(TELEM_KEYS)} values in TELEM_KEYS "
                         f"order, got {len(values)}")
    if prev is None:
        full = True
    out = bytearray(TELEM_MAGIC)
    mask = 0
    deltas = bytearray()
    for i, v in enumerate(values):
        d = int(v) - (0 if full else int(prev[i]))
        if full or d != 0:
            mask |= 1 << i
            _varint(deltas, _zigzag(d))
    out += _TELEM_HDR.pack(1 if full else 0, rank, epoch,
                           seq & 0xFFFFFFFF, mask)
    out += deltas
    return bytes(out)


def decode_telem(raw: bytes) -> Tuple[int, int, int, bool,
                                      Dict[str, int]]:
    """Decode one digest: ``(rank, epoch, seq, full, {key: delta})``.
    Raises ValueError on a malformed payload (bad magic, truncated
    header or varint section, mask bits beyond the schema)."""
    if len(raw) < TELEM_HEADER_SIZE or \
            raw[:len(TELEM_MAGIC)] != TELEM_MAGIC:
        raise ValueError("not a telemetry digest")
    flags, rank, epoch, seq, mask = _TELEM_HDR.unpack_from(
        raw, len(TELEM_MAGIC))
    if mask >> len(TELEM_KEYS):
        raise ValueError(f"digest mask {mask:#x} has bits beyond the "
                         f"{len(TELEM_KEYS)}-key schema")
    deltas: Dict[str, int] = {}
    pos = TELEM_HEADER_SIZE
    for i, key in enumerate(TELEM_KEYS):
        if not mask & (1 << i):
            continue
        u = 0
        shift = 0
        while True:
            # same validity bound as the C decoder (rlo_wire.c):
            # a varint past 64 payload bits is malformed, not a bigint
            if pos >= len(raw) or shift > 63:
                raise ValueError("truncated/overlong digest varint")
            b = raw[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        deltas[key] = _unzigzag(u)
    return rank, epoch, seq, bool(flags & 1), deltas


# ---------------------------------------------------------------------------
# Span context codec (docs/DESIGN.md §19). One span context = the
# compact causal stamp a traced request carries in-band: appended as a
# TRAILER to existing fabric record payloads (ADMIT / DONE / PLACE —
# never a new record kind, never a header change), so every rank the
# record reaches can emit a stage-boundary span into the engine tracer
# rings without any side channel. The byte layout is PINNED so the C
# engine can recognise and decode the trailer on its wire-hop path
# (rlo_wire.c rlo_span_encode / rlo_span_decode; parity asserted by
# tests/test_spans.py):
#
#   offset 0   magic   "RLOS\x01"                     (5 bytes)
#   offset 5   flags   u8    bit0 = sampled (emit spans for this rid)
#   offset 6   stage   u8    observe.spans.Stage of the record boundary
#   offset 7   gateway i32le rid gateway rank (-1 on fleet-level spans,
#                            e.g. placement rounds keyed by version)
#   offset 11  seq     i32le rid sequence (low 31 bits — the trailer
#                            identifies, the full-width rid lives in
#                            the record body)
#   offset 15  t_usec  u64le stage START on the ORIGIN's engine clock
#
# Discrimination is structural: every fabric record body is its fixed
# header plus a whole number of i32 words, so (len - base) % 4 == 0 on
# a clean record and == SPAN_CTX_SIZE % 4 == 3 with a trailer — the
# magic check then confirms. Records without a trailer are
# byte-identical to the pre-span wire format (the zero-overhead
# contract the bench gates pin).
# ---------------------------------------------------------------------------

#: span-context trailer magic
# rlo-lint: paired-with rlo_core.h:RLO_SPAN_MAGIC
SPAN_MAGIC = b"RLOS\x01"

#: fixed trailer size; % 4 == 3 is what makes the trailer structurally
#: unambiguous against i32-word record payloads
# rlo-lint: paired-with rlo_core.h:RLO_SPAN_CTX_SIZE
SPAN_CTX_SIZE = 23

_SPAN_CTX = struct.Struct("<BBiiQ")  # flags, stage, gateway, seq, t_usec

#: flags bit0 — this rid was selected by the deterministic sampler
SPAN_F_SAMPLED = 1


def encode_span_ctx(gateway: int, seq: int, stage: int, t_usec: int,
                    flags: int = SPAN_F_SAMPLED) -> bytes:
    """Encode one span-context trailer (SPAN_CTX_SIZE bytes)."""
    return SPAN_MAGIC + _SPAN_CTX.pack(
        flags & 0xFF, stage & 0xFF, gateway, seq & 0x7FFFFFFF,
        t_usec & 0xFFFFFFFFFFFFFFFF)


def decode_span_ctx(raw: bytes, off: int = 0) \
        -> Optional[Tuple[int, int, int, int, int]]:
    """Decode a span context at ``raw[off:]``: ``(flags, stage,
    gateway, seq, t_usec)``, or None when the bytes there are not a
    span context (wrong magic / too short) — absence is the common
    case, not an error."""
    if len(raw) - off < SPAN_CTX_SIZE or \
            raw[off:off + len(SPAN_MAGIC)] != SPAN_MAGIC:
        return None
    flags, stage, gateway, seq, t_usec = _SPAN_CTX.unpack_from(
        raw, off + len(SPAN_MAGIC))
    return flags, stage, gateway, seq, t_usec


def split_span_ctx(body: bytes, base: int) \
        -> Tuple[int, Optional[Tuple[int, int, int, int, int]]]:
    """Split a fabric record body into ``(payload_end, ctx)`` where
    ``base`` is the record kind's fixed-header size and the payload
    after it is a whole number of i32 words. Returns ``(len(body),
    None)`` for clean records — one modulo and one compare on the hot
    path, nothing else."""
    if len(body) >= base + SPAN_CTX_SIZE and \
            (len(body) - base) % 4 == SPAN_CTX_SIZE % 4:
        ctx = decode_span_ctx(body, len(body) - SPAN_CTX_SIZE)
        if ctx is not None:
            return len(body) - SPAN_CTX_SIZE, ctx
    return len(body), None
