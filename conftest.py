"""Glue for the benchmark's own tests (``portbench/tests``) that they
cannot carry themselves yet.

``portbench/tests/test_portbench_run.py::_unchanged`` injects the fault
"each answer is its request's input" by cloning each batched input, as
when PlanServe handed ``compile_batched`` one stacked tensor.  PlanServe
now hands it the members' own tensors, a tuple: the fixture below stacks
such a tuple before that helper clones it, so the fault and the test's
assertion stay as they are.  It goes once the benchmark's test stacks
the sequence itself."""
import pytest


@pytest.fixture(autouse=True)
def _stack_members_for_unchanged(request, monkeypatch):
    module = getattr(request.node, "module", None)
    if not (module is not None
            and module.__name__.endswith("test_portbench_run")
            and hasattr(module, "_unchanged")):
        yield
        return
    import torch
    real = module._unchanged

    def _unchanged(cell):
        change = real(cell)
        return lambda fn, arrays: change(fn, {
            k: torch.stack(v) if isinstance(v, tuple) else v
            for k, v in arrays.items()})

    monkeypatch.setattr(module, "_unchanged", _unchanged)
    yield
