"""AdamW over the port's parameter tree (the port of ``repro.optim``)."""
