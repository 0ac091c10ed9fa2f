"""Training substrate of the port: optimizers, step factories, checkpointing,
fault tolerance. Counterpart of ``repro/train``."""
