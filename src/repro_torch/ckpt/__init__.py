"""Checkpoints with atomic commits (the port of ``repro.ckpt``)."""
