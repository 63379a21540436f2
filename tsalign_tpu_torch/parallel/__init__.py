"""Batched and multi-device execution: the port's copy of
``tsalign_tpu/parallel`` (``batch_ts``, ``fused_rounds``, ``batch``,
``sp_sweep``, ``sp_reentry``), with ``mesh`` in place of ``jax.sharding.Mesh``
and its collectives."""
