"""HFAV core on PyTorch: the paper's fusion/vectorization engine.

The port's counterpart of ``repro.core``; see
:func:`repro_torch.core.engine.compile_program` for the entry point.
"""

#: Build stamp folded into on-disk plan-cache keys and entry headers
#: (:mod:`repro_torch.core.plancache`): bump alongside behavior changes
#: that should invalidate persisted plans without a schema change.
__version__ = "0.1.0"

from .codegen_torch import Generated
from .dataflow import build_dataflow
from .engine import (BACKENDS, BatchedGenerated, clear_compile_cache,
                     compile_batched, compile_cache_size, compile_program,
                     explain, pallas_auto_viable, plan_cache_cap,
                     plan_cache_size, program_signature,
                     register_pallas_split_win, set_plan_cache_cap)
from .fusion import FusedSchedule, Unfusable, fuse_inest_dag
from .infer import IDAG, InferenceError, infer
from .interpreters import (InterpreterSpec, PlanUnsupported, execute_plan,
                           get_interpreter, register_interpreter,
                           registered_interpreters, unregister_interpreter)
from .layoutapply import (APPLY_MODES, HANDLED_HINTS, LayoutApplyResult,
                          apply_layout, render_apply, resolve_apply_mode)
from .plan import (PLAN_FEATURES, SCHEMA_VERSION, CallPlan, KernelPlan,
                   LanePass, LayoutHint, PallasUnsupported,
                   PlanSerializationError, VecLoadPlan, fn_key,
                   from_reference_dict, register_step_builder,
                   unregister_step_builder)
from .plancache import PlanCache, program_plan_key
from .plancheck import (Diagnostic, PlanCheckError, PlanCheckWarning,
                        check_plan, has_errors, pad_to_lane,
                        sizes_from_arrays, vmem_bytes, vmem_report)
from .planner import PallasGenerated, plan_pallas
from .programs import ALL_PROGRAMS
from .reuse import analyze_storage, reuse_graph, reuse_order
from .rules import Extent, KernelRule, Program, axiom, goal, kernel
from .terms import Term, parse_term, unify_term
from .unfused import build_unfused
from .vecscan import (ACCESS_CLASSES, AccessSite, VecReport,
                      attach_layout_hints, auto_vec_reject, render_vec,
                      scan_plan)

__all__ = [
    "ACCESS_CLASSES", "ALL_PROGRAMS", "APPLY_MODES", "AccessSite",
    "BACKENDS", "BatchedGenerated", "CallPlan", "Diagnostic", "Extent",
    "FusedSchedule", "Generated", "HANDLED_HINTS", "IDAG",
    "InferenceError", "InterpreterSpec", "KernelPlan", "KernelRule",
    "LanePass", "LayoutApplyResult", "LayoutHint", "PLAN_FEATURES",
    "PallasGenerated", "PallasUnsupported", "PlanCache", "PlanCheckError",
    "PlanCheckWarning", "PlanSerializationError", "PlanUnsupported",
    "Program", "SCHEMA_VERSION", "Term", "Unfusable", "VecLoadPlan",
    "VecReport", "analyze_storage", "apply_layout", "attach_layout_hints",
    "auto_vec_reject", "axiom", "build_dataflow", "build_unfused",
    "check_plan", "clear_compile_cache", "compile_batched",
    "compile_cache_size", "compile_program", "execute_plan", "explain",
    "fn_key", "from_reference_dict", "fuse_inest_dag", "get_interpreter",
    "goal", "has_errors", "infer", "kernel", "pad_to_lane",
    "pallas_auto_viable", "parse_term", "plan_cache_cap",
    "plan_cache_size", "plan_pallas", "program_plan_key",
    "program_signature", "register_interpreter",
    "register_pallas_split_win", "register_step_builder",
    "registered_interpreters", "render_apply", "render_vec",
    "resolve_apply_mode", "reuse_graph", "reuse_order", "scan_plan",
    "set_plan_cache_cap", "sizes_from_arrays", "unify_term",
    "unregister_interpreter", "unregister_step_builder", "vmem_bytes",
    "vmem_report",
]
