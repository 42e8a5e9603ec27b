"""``plan_ms``: host time of the compile (the front end and planner, or
the plan from the on-disk cache): ``compile_program`` timed by the
harness in a step loop, PlanServe's own compile time
(``metrics.compile_ms``) in a closed loop."""


def read(run):
    return run.plan_ms
