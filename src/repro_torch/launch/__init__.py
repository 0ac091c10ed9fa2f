"""Launch layer of the port. Counterpart of ``repro/launch``: the training
entry point (``train``), the pod target the reference prices meshes for
(``hwspecs``) and the three-term roofline with the parameter and FLOP
counts (``roofline``), and the meshes over ``torch.distributed``
(``mesh``). The dry run (``dryrun``) is still to be ported (ROADMAP Queue 1
item 5)."""
