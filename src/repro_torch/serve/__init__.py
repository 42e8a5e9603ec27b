"""Serving: the LM stack's prefill and greedy decode (the port of
``repro.serve.engine``), and PlanServe, the server of compiled stencil
programs (:mod:`repro_torch.serve.plans`, :mod:`repro_torch.serve.workers`)."""
from .engine import greedy_decode, make_decode_step, make_prefill_step
from .plans import PlanServe, ServeMetrics, ServeTicket

__all__ = ["PlanServe", "ServeMetrics", "ServeTicket", "greedy_decode",
           "make_decode_step", "make_prefill_step"]
