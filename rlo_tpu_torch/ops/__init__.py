"""Per-rank collective functions (``device_collectives``) and
sequence-parallel attention (``ring_attention``, ``ulysses``)."""
