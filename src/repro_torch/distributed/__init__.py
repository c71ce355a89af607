"""Training state and the multi-rank paths of the port: AdamW with float32
or int8 state (:mod:`.optimizer`), atomic checkpoints in the JAX package's
on-disk format with a resharding restore (:mod:`.checkpoint`), the
logical-axis sharding rules on DeviceMesh/DTensor (:mod:`.sharding`) and
the int8 gradient all-reduce with error feedback (:mod:`.compression`)."""
