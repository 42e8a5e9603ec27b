"""Metric readers: one module per metric, ``metrics/<name>.py`` (a ``.``
or ``-`` in the metric's name becomes ``_``), each with
``read(run) -> float | None``.  ``run`` is :class:`portbench.harness.Run`.
A reader that finds nothing to read returns None, and the metric is left
out of the result line."""
from __future__ import annotations

import importlib


def module_name(metric: str) -> str:
    return metric.replace(".", "_").replace("-", "_")


def load(metric: str):
    return importlib.import_module(f"{__name__}.{module_name(metric)}")
