"""The compiler's tooling as modules of the package (the port of the
reference's ``scripts/warm_cache.py`` and ``scripts/plan_lint.py``):
``python -m repro_torch.scripts.warm_cache`` and
``python -m repro_torch.scripts.plan_lint``."""
