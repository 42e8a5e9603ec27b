"""The training step (the port of ``repro.train``)."""
