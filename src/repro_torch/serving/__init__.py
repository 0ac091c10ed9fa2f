"""Serving substrate of the port: KV caches (bf16 / quantized int8).
Counterpart of ``repro/serving``."""
