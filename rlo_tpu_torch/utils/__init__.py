"""Host-side utilities of the port (``metrics``: the serving registry;
``checkpoint``: pytree checkpoints and stepped retention)."""
