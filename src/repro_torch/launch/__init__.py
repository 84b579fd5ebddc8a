"""Command-line launchers of the port; counterpart of `repro.launch`
(`train` and `serve`; the reference's dry-run, mesh, HLO and roofline
tools need a device mesh or XLA HLO, and are not ported)."""
