"""The flagship transformer and its serving path: ``transformer`` (the
layer math), ``generate`` (KV-cache prefill, decode and generation) and
``serve`` (the continuous-batching ``DecodeServer``); ``pipeline``
trains it over a ``pp`` axis (GPipe and 1F1B)."""
