"""Loops: one module per loop a traffic mix may name (its ``loop``),
``loops/<loop>.py``, each with a class ``Loop``.  ``Loop(program, config,
mix, fields, device, dtype)`` compiles or serves the program in its
set-up and keeps ``plan_ms``; ``warm()`` runs every shape the window will
use; ``window(seconds, tracer)`` returns a
:class:`portbench.generator.Window`; ``judged()`` gives the (inputs,
outputs) pairs compared with the reference; ``close()`` frees the
program's state."""
from __future__ import annotations

import importlib


def load(loop: str):
    return importlib.import_module(f"{__name__}.{loop}").Loop
