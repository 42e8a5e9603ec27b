"""Launchers (the port of ``repro.launch``): the training loop, the
production and host meshes, the dry run's cells and the dry run."""
