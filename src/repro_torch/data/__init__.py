"""Synthetic data pipelines (the vision stream of the NAS proxy task)."""
