"""The LM stack on PyTorch: the port of ``repro.models`` (the dense, vlm,
moe, ssm, hybrid and encdec families; see :mod:`repro_torch.models.lm`)."""
from .convert import params_from_jax
from .lm import decode_step, forward, init_caches, init_params

__all__ = ["decode_step", "forward", "init_caches", "init_params",
           "params_from_jax"]
