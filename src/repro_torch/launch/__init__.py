"""Command-line launchers and planning tools of the port; counterpart of
`repro.launch`: `train` and `serve`; `mesh` (device meshes over a
process group, and the one card's (1, 1) mesh); `dryrun` (every arch x
shape x mesh cell traced on fake tensors), `op_analyzer` (its costs: the
counterpart of the reference's HLO analyzer) and `roofline` (the H100's
rates over the dry run's records)."""
