"""The port's tools.

Measurement tools that run on the card (``profile_*``, ``time_*``,
``gloo_cuda_probe``, ``multihost_demo``, ``twin_bits``), and the
developer tools of the JAX package's ``rlo_tpu/tools/`` ported to read
the port's own files (``rlo_tpu_torch/...``) with the same rule IDs,
CLI flags, ``--json`` schema and exit codes: the static analyzers
``rlo_lint``, ``rlo_sentinel``, ``rlo_prover`` and ``rlo_model`` with
their shared ``runner`` and C front end ``csrc``, and the runtime tools
``rlo_scope``, ``rlo_top``, ``rlo_trace`` and ``perf_gate``.
"""
