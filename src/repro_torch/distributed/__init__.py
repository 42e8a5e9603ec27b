"""Sharding rules, the active-mesh context and GPipe pipelining on
``torch.distributed`` (the port of ``repro.distributed``)."""
