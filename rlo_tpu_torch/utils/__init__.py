"""Host-side utilities of the port (``metrics``: the serving registry)."""
