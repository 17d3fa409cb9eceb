"""Socket-mesh transport: one process a rank, a full mesh of TCP sockets.

The port's counterpart of the JAX package's C transport
``rlo_tpu/native/rlo_tcp.c``, in plain ``socket`` and ``selectors``:

  - **Set-up.** Rank r binds a listening socket on port 0 and publishes
    ``host:port`` under ``<prefix>/<r>`` in a ``torch.distributed``
    ``Store`` (so processes never collide on a port). It connects to
    every lower rank and sends a 4-byte hello (its rank), then accepts
    one connection from every higher rank and reads its hello. After
    set-up every socket is nonblocking with ``TCP_NODELAY``.
  - **Wire.** Each frame goes as a ``[src:i32][tag:i32][comm:i32]
    [pad:i32][len:i64]`` header followed by its bytes; the destination
    is implied by the socket. ``comm`` demultiplexes channels: each
    ``TcpTransport`` of one ``TcpWorld`` is a channel with its own inbox
    and counters, so a member-only engine can share the sockets of the
    full world.
  - **Sends.** A frame is queued per destination (FIFO) and flushed from
    ``isend`` and from every ``poll``; its ``SendHandle`` is done once the
    kernel has taken every byte of it. A short write leaves the rest of
    the frame at the head of the queue, so per-peer byte order is queue
    order.
  - **Receives.** ``poll`` flushes, reads what the sockets hold, cuts
    whole frames out of each peer's buffer into their channel's inbox and
    hands back the next one of its own channel, or None: it never
    blocks.
  - **Failure.** A peer's EOF or reset marks it failed: sends to it
    complete failed, as on the loopback world's dead ranks.

The reference's scatter-gather flush (``sendmsg`` over many frames) and
its ``isend_hdr`` gather op are optimisations this port leaves out.
Termination detection (the ``[sent, delivered]`` sums that
``rlo_tcp.c`` runs over its own control frames) lives with the
process group that carries it: ``parallel/multihost.py``'s drain.
"""

from __future__ import annotations

import selectors
import socket
import struct
import time
from collections import deque
from typing import Dict, Optional, Tuple

from rlo_tpu_torch.transport.base import FAILED_SEND, SendHandle, Transport

#: frame header: src, tag, comm, pad, len
HDR = struct.Struct("<iiiiq")
_HELLO = struct.Struct("<i")
_CONNECT_TIMEOUT_S = 60.0
_READ_CHUNK = 1 << 20


class _TcpSend(SendHandle):
    """Done once the kernel has taken every byte of the frame."""
    __slots__ = ("taken",)

    def __init__(self):
        self.taken = False

    def done(self) -> bool:
        return self.taken


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("peer closed the socket during set-up")
        buf += part
    return buf


class TcpWorld:
    """This process's endpoint of a full TCP mesh over ``world_size``
    ranks.

    ``store`` is a ``torch.distributed`` ``Store`` that every member
    reaches (a ``FileStore``, a ``TCPStore``, the default group's store);
    ``prefix`` keeps one mesh's keys apart from another's on the same
    store. ``sndbuf`` shrinks ``SO_SNDBUF`` (to force partial writes).
    """

    def __init__(self, rank: int, world_size: int, store, *,
                 prefix: str = "rlo_tcp",
                 host: str = "127.0.0.1", sndbuf: Optional[int] = None,
                 timeout: float = _CONNECT_TIMEOUT_S):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        self.rank = rank
        self.world_size = world_size
        self._socks: Dict[int, socket.socket] = {}
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind((host, 0))
            lsock.listen(world_size)
            lsock.settimeout(timeout)
            port = lsock.getsockname()[1]
            store.set(f"{prefix}/{rank}", f"{host}:{port}")
            for peer in range(rank):
                h, p = store.get(f"{prefix}/{peer}").decode().rsplit(":", 1)
                self._socks[peer] = self._connect(h, int(p), timeout)
            for _ in range(rank + 1, world_size):
                conn, _addr = lsock.accept()
                conn.settimeout(timeout)
                (peer,) = _HELLO.unpack(_recv_exact(conn, _HELLO.size))
                if not rank < peer < world_size or peer in self._socks:
                    conn.close()
                    raise ConnectionError(f"rank {rank}: unexpected hello "
                                          f"from {peer}")
                self._socks[peer] = conn
        except BaseException:
            for s in self._socks.values():
                s.close()
            raise
        finally:
            lsock.close()
        self._sel = selectors.DefaultSelector()
        for peer, s in self._socks.items():
            s.setblocking(False)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if sndbuf is not None:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
            self._sel.register(s, selectors.EVENT_READ, peer)
        # per destination: [frame bytes, bytes taken, handle] in FIFO order
        self._outq: Dict[int, deque] = {p: deque() for p in self._socks}
        self._inbuf: Dict[int, bytearray] = {p: bytearray()
                                             for p in self._socks}
        self.failed: set = set()
        self._channels: Dict[int, "TcpTransport"] = {}
        self._closed = False

    def _connect(self, host: str, port: int,
                 timeout: float) -> socket.socket:
        deadline = time.monotonic() + timeout
        while True:
            try:
                s = socket.create_connection((host, port), timeout=timeout)
                s.sendall(_HELLO.pack(self.rank))
                return s
            except (ConnectionRefusedError, ConnectionResetError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)

    # -- channels ----------------------------------------------------------

    def transport(self, comm: int = 0) -> "TcpTransport":
        """The channel ``comm`` of this mesh (created on first use)."""
        ch = self._channels.get(comm)
        if ch is None:
            ch = self._channels[comm] = TcpTransport(self, comm)
        return ch

    # -- sends -------------------------------------------------------------

    def _send(self, dst: int, tag: int, comm: int,
              data: bytes) -> SendHandle:
        if dst not in self._socks:
            raise ValueError(f"bad destination rank {dst}")
        if dst in self.failed:
            return FAILED_SEND
        h = _TcpSend()
        frame = HDR.pack(self.rank, tag, comm, 0, len(data)) + bytes(data)
        self._outq[dst].append([memoryview(frame), 0, h])
        self._flush(dst)
        return h

    def _flush(self, dst: int) -> None:
        q = self._outq[dst]
        s = self._socks[dst]
        while q:
            ent = q[0]
            view, off = ent[0], ent[1]
            try:
                n = s.send(view[off:])
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._fail(dst)
                return
            off += n
            if off < len(view):
                ent[1] = off
                return
            ent[2].taken = True
            q.popleft()

    def _fail(self, peer: int) -> None:
        if peer in self.failed:
            return
        self.failed.add(peer)
        for ent in self._outq[peer]:
            ent[2].taken = True
            ent[2].failed = True
        self._outq[peer].clear()
        try:
            self._sel.unregister(self._socks[peer])
        except (KeyError, ValueError):
            pass

    # -- receives ----------------------------------------------------------

    def _pump(self) -> None:
        """Flush every queue, then read whatever the sockets hold and
        cut it into frames; never blocks."""
        for dst, q in self._outq.items():
            if q:
                self._flush(dst)
        if self._closed or not self._sel.get_map():
            return
        for key, _ in self._sel.select(timeout=0):
            peer = key.data
            buf = self._inbuf[peer]
            try:
                while True:
                    part = key.fileobj.recv(_READ_CHUNK)
                    if not part:
                        self._fail(peer)
                        break
                    buf += part
                    if len(part) < _READ_CHUNK:
                        break
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._fail(peer)
            self._cut(peer, buf)

    def _cut(self, peer: int, buf: bytearray) -> None:
        off = 0
        while len(buf) - off >= HDR.size:
            src, tag, comm, _pad, n = HDR.unpack_from(buf, off)
            if len(buf) - off - HDR.size < n:
                break
            start = off + HDR.size
            data = bytes(buf[start:start + n])
            off = start + n
            self.transport(comm)._inbox.append((src, tag, data))
        if off:
            del buf[:off]

    def quiescent(self) -> bool:
        """Nothing of this process waits to be sent or read: every send
        queue is empty and no channel holds an undelivered frame. (Frames
        in the kernel or on the wire are invisible here; the process
        group's drain counts them.)"""
        return (not any(self._outq.values())
                and not any(ch._inbox for ch in self._channels.values()))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._sel.close()
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass


class TcpTransport(Transport):
    """One channel (``comm``) of a ``TcpWorld``: the engine's endpoint.
    ``sent`` and ``delivered`` count this channel's frames handed to
    ``isend`` and handed out by ``poll``, the two sums of the drain."""

    def __init__(self, world: TcpWorld, comm: int):
        self.world = world
        self.comm = comm
        self.rank = world.rank
        self.world_size = world.world_size
        self._inbox: deque = deque()
        self.sent = 0
        self.delivered = 0

    def isend(self, dst: int, tag: int, data: bytes) -> SendHandle:
        h = self.world._send(dst, tag, self.comm, data)
        if h is not FAILED_SEND:
            self.sent += 1
        return h

    def poll(self) -> Optional[Tuple[int, int, bytes]]:
        self.world._pump()
        if self._inbox:
            self.delivered += 1
            return self._inbox.popleft()
        return None

    def quiescent(self) -> bool:
        """This channel holds no undelivered frame and the mesh has
        nothing left to send."""
        return not self._inbox and not any(self.world._outq.values())

    def close(self) -> None:
        self.world.close()
