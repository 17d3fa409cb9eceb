"""The port's copy of the native C core: the C11 library the JAX package
carries in ``rlo_tpu/native``, kept here with its own build so the port
stands alone. ``rlo_tpu_torch.native.bindings`` builds it on first use
into ``_build/`` (git-ignored) and exposes ctypes wrappers
(``NativeWorld``, ``NativeEngine``, ``NativeColl``) mirroring the Python
engine API; ``rlo_tpu_torch.native.build.build_tool`` runs the
Makefile's targets, which build the launcher (``femtompirun``), the
scenario runners and the sanitized selftest there too (``python3 -m
rlo_tpu_torch.native.build femtompirun``). Importing this package
builds nothing.
"""
