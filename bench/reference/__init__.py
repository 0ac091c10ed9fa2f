"""The plain reference: plain PyTorch in float32, importing neither JAX, repro nor repro_torch."""
