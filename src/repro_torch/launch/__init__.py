"""Launch layer of the port: the training entry point. Counterpart of
``repro/launch`` (the mesh, dry-run and roofline come with later slices)."""
