"""Batched pair alignment on one device (the port's copy of
``tsalign_tpu/parallel``: ``batch_ts`` only; the mesh-only modules are not
ported)."""
