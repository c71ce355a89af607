"""Training state of the port on one device: AdamW with float32 or int8
state (:mod:`.optimizer`) and atomic checkpoints in the JAX package's
on-disk format (:mod:`.checkpoint`).  Sharding, gradient compression and
the multi-rank paths are not ported yet."""
