"""Launch layer of the port. Counterpart of ``repro/launch``: the training
entry point (``train``), the pod target the reference prices meshes for
(``hwspecs``) and the three-term roofline with the parameter and FLOP
counts (``roofline``). The mesh (``mesh``) and the dry run (``dryrun``)
come with the parallel slice."""
