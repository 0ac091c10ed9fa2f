"""Launch layer of the port. Counterpart of ``repro/launch``: the training
entry point (``train``), the pod target the reference prices meshes for
(``hwspecs``), the three-term roofline with the parameter and FLOP counts
(``roofline``), the meshes over ``torch.distributed`` (``mesh``), and the
dry run (``dryrun``): a shape-only trace of each cell's sharded step as
one rank of the production mesh, which writes the records
``roofline.analyze`` reads."""
