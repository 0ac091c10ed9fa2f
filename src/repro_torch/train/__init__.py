"""Step factories of the port (serving so far). Counterpart of
``repro/train``; the optimizers, training steps and checkpointing come
with the training slice."""
