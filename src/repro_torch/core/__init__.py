"""HFAV core on PyTorch: the paper's fusion/vectorization engine.

The port's counterpart of ``repro.core``; see
:func:`repro_torch.core.engine.compile_program` for the entry point.
"""
from .engine import clear_compile_cache, compile_cache_size, compile_program
from .interpreters import (InterpreterSpec, PlanUnsupported, execute_plan,
                           get_interpreter, register_interpreter,
                           registered_interpreters, unregister_interpreter)
from .plan import (PLAN_FEATURES, SCHEMA_VERSION, CallPlan, KernelPlan,
                   PallasUnsupported, from_reference_dict)
from .planner import PallasGenerated, plan_pallas
from .programs import ALL_PROGRAMS
from .rules import Program, axiom, goal, kernel
from .unfused import build_unfused

__all__ = [
    "ALL_PROGRAMS", "CallPlan", "InterpreterSpec", "KernelPlan",
    "PLAN_FEATURES", "PallasGenerated", "PallasUnsupported",
    "PlanUnsupported", "Program", "SCHEMA_VERSION", "axiom",
    "build_unfused", "clear_compile_cache", "compile_cache_size",
    "compile_program", "execute_plan", "from_reference_dict",
    "get_interpreter", "goal", "kernel", "plan_pallas",
    "register_interpreter", "registered_interpreters",
    "unregister_interpreter",
]
