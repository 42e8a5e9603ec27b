"""The LM stack on PyTorch: the port of ``repro.models`` (the dense, vlm,
moe, ssm, hybrid and encdec families; see :mod:`repro_torch.models.lm`)."""
from .convert import opt_state_from_jax, params_from_jax, params_to_jax
from .lm import decode_step, forward, init_caches, init_params

__all__ = ["decode_step", "forward", "init_caches", "init_params",
           "opt_state_from_jax", "params_from_jax", "params_to_jax"]
