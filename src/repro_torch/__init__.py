"""PyTorch / CUDA port of the NAHAS reproduction, beside the JAX package
``repro`` that it is held against.

Module for module it mirrors ``src/repro/``: numpy code is copied (and
stays bitwise-equal), tensor code is PyTorch, and each Pallas TPU kernel on
a ported path becomes a hand-written Hopper kernel under ``kernels/``. The
package imports torch and numpy, never jax and nothing of ``repro``.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""
