"""Draws: one module per distribution a configuration's input may name
(its ``draw``), ``draws/<draw>.py``, each with ``draw(g, shape, device)``
returning a float32 tensor made on ``device`` from the generator ``g``
in a few large calls."""
from __future__ import annotations

import importlib


def load(draw: str):
    return importlib.import_module(f"{__name__}.{draw}").draw
