"""Launchers (the port of ``repro.launch``; the training loop so far)."""
