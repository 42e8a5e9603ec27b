"""Heartbeats and straggler detection (the port of ``repro.ft``)."""
