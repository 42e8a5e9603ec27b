"""The reference's ``examples/`` on the port's backends, each run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``)."""
