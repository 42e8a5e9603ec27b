"""Serving the LM stack: prefill and greedy decode (the port of
``repro.serve.engine``)."""
from .engine import greedy_decode, make_decode_step, make_prefill_step

__all__ = ["greedy_decode", "make_decode_step", "make_prefill_step"]
