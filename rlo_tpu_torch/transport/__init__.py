"""Byte transports the port's progress engine runs over: ``loopback`` (N
ranks in one process), ``tcp`` (one process a rank, a socket mesh;
``rlo_tpu_torch.transport.tcp``) and ``sim`` (the deterministic
simulator the fabric and the membership stack are proven in;
``rlo_tpu_torch.transport.sim``)."""

from rlo_tpu_torch.transport.base import (Transport, SendHandle, make_world,
                                          register_transport)
from rlo_tpu_torch.transport import loopback  # registers "loopback"

__all__ = ["Transport", "SendHandle", "make_world", "register_transport",
           "loopback"]
