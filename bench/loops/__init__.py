"""The general loops, one a kind of traffic mix (train, prefill)."""
