"""The synthetic token pipeline (the port of ``repro.data``)."""
