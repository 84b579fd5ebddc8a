"""Command-line launchers of the port; counterpart of `repro.launch`
(`train` so far)."""
