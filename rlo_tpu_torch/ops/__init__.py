"""Per-rank collective functions (``device_collectives``), the host
collectives over the byte transports (``collectives``: the loopback
facade's data plane) and sequence-parallel attention (``ring_attention``,
``ulysses``)."""
