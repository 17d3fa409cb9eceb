"""Mesh axes (``mesh``), partition specs and per-rank slices of a tree
(``sharding``) and the host-side consensus protocol (``consensus``)."""
