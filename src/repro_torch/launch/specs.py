"""Per-(architecture x shape) cell builders for the dry run (the port
of ``repro.launch.specs``).

``build_cell`` returns everything a run of the cell needs: the step
function, its abstract arguments (meta tensors of the global shapes:
never allocated) and their specs over the mesh.  ``Cell.place`` lays
arguments out as DTensors on the mesh by those specs (the abstract ones
in the dry run, real ones on a card), and ``Cell.run`` calls the step
on them under the mesh.  ``train_*`` cells run ``train_step``;
``prefill_*`` the cache-building prefill; ``decode_*`` / ``long_*`` the
serving step (one token against a ``seq_len`` KV cache).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..configs import SHAPES, ArchConfig, ShapeCfg, get_arch
from ..distributed.ctx import use_mesh
from ..distributed.sharding import (Spec, axis_sizes, batch_axes,
                                    cache_specs, distribute, param_specs)
from ..models import init_caches, init_params
from ..models.lm import cast
from ..optim.adamw import AdamWCfg, init_opt_state
from ..serve.engine import make_decode_step, make_prefill_step
from ..train.step import make_train_step

# per-chip activation budget driving the microbatch choice (bf16 carries)
ACT_BUDGET_BYTES = 2e9


def skip_reason(cfg: ArchConfig, shape: ShapeCfg) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full attention at 524288-token decode has no sub-quadratic "
                "path (DESIGN.md §Shape/skip policy)")
    return None


def microbatches_for(cfg: ArchConfig, shape: ShapeCfg, n_chips: int) -> int:
    total_act = cfg.n_layers * shape.global_batch * shape.seq_len * cfg.d_model * 2
    need = total_act / (n_chips * ACT_BUDGET_BYTES)
    m = 1
    while m < need and m < shape.global_batch:
        m *= 2
    return m


def _abstract_params(cfg: ArchConfig, dtype=None) -> dict:
    params = init_params(torch.Generator(), cfg, device="meta")
    return params if dtype is None else cast(params, dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_struct(cfg: ArchConfig, shape: ShapeCfg, *, train: bool) -> dict:
    GB, S = shape.global_batch, shape.seq_len
    batch: dict[str, Any] = {"tokens": _meta((GB, S), torch.int32)}
    if train:
        batch["targets"] = _meta((GB, S), torch.int32)
    if cfg.family == "encdec":
        batch["enc_frames"] = _meta((GB, cfg.encdec.enc_seq, cfg.d_model),
                                    torch.bfloat16)
    if cfg.family == "vlm":
        batch["positions"] = _meta((3, GB, S), torch.int32)
    return batch


def batch_specs(batch: dict, mesh, policy: str = "fsdp_tp") -> dict:
    """A batch's specs: batch dim over the data axes (axis 1 of M-RoPE
    ``positions``)."""
    b = batch_axes(mesh, policy)
    specs = {}
    for name, leaf in batch.items():
        if name == "positions":
            specs[name] = Spec(None, b, None)
        elif name == "enc_frames":
            specs[name] = Spec(b, None, None)
        else:
            specs[name] = Spec(b, *([None] * (leaf.ndim - 1)))
    return specs


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    mesh: Any
    policy: str
    microbatches: int = 1

    def place(self, *args) -> tuple:
        """``args`` (default: the abstract ones) as DTensors on the mesh,
        each leaf laid out by its spec."""
        return tuple(distribute(a, s, self.mesh) for a, s in
                     zip(args or self.args, self.in_shardings))

    def run(self, *placed):
        """The step on placed arguments, under the mesh."""
        with use_mesh(self.mesh, self.policy):
            return self.fn(*placed)


def layer_unit(cfg: ArchConfig) -> int:
    return cfg.hybrid.attn_every if cfg.hybrid is not None else 1


def with_units(cfg: ArchConfig, units: int, shape: ShapeCfg) -> ArchConfig:
    """Reduced-depth config for the counted runs, which the dry run
    extrapolates to full depth (see roofline/analysis.py).  ``unroll``
    is kept for the reference's field; the port's layers are a Python
    loop already."""
    kw: dict = {"n_layers": units * layer_unit(cfg), "unroll": True}
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_enc_layers=units)
    if shape.kind == "decode" and shape.seq_len > 65536:
        kw["attn_chunk"] = 8192  # as the reference's: its KV scan unrolled
    if cfg.ssm is not None and shape.kind != "decode":
        # the reference's cap of ~32 SSD chunks a layer (its unrolled
        # compile); the chunk size shifts the intra/inter flop split
        kw["ssd_chunk"] = max(cfg.ssd_chunk, shape.seq_len // 32)
    return cfg.replace(**kw)


def target_units(cfg: ArchConfig) -> int:
    return cfg.n_layers // layer_unit(cfg)


def build_cell(arch: str, shape_name: str, mesh, *,
               cfg_override: ArchConfig | None = None,
               microbatch_override: int | None = None,
               policy: str | None = None, grad_comp: str = "none",
               device="meta") -> Cell:
    """The cell's step for ``device`` (the mesh's tensors live there; the
    abstract arguments are meta tensors whatever it is)."""
    cfg = cfg_override or get_arch(arch)
    policy = policy or cfg.parallelism
    shape = SHAPES[shape_name]
    n_chips = math.prod(axis_sizes(mesh).values())
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"cell skipped: {reason}")
    common = dict(mesh=mesh, policy=policy)

    if shape.kind == "train":
        mb = microbatch_override or microbatches_for(get_arch(arch), shape,
                                                     n_chips)
        params = _abstract_params(cfg)
        opt = init_opt_state(params)
        batch = _batch_struct(cfg, shape, train=True)
        pspec = param_specs(params, mesh, policy)
        ospec = {"m": pspec, "v": pspec, "step": None}
        fn = make_train_step(cfg, AdamWCfg(grad_compression=grad_comp),
                             microbatches=mb)
        return Cell(arch, shape_name, "train", fn,
                    (params, opt, batch),
                    (pspec, ospec, batch_specs(batch, mesh, policy)),
                    microbatches=mb, **common)

    params = _abstract_params(cfg, dtype=torch.bfloat16)
    pspec = param_specs(params, mesh, policy)
    b = batch_axes(mesh, policy)

    if shape.kind == "prefill":
        batch = _batch_struct(cfg, shape, train=False)
        fn = make_prefill_step(cfg, device=device)
        return Cell(arch, shape_name, "prefill", fn, (params, batch),
                    (pspec, batch_specs(batch, mesh, policy)), **common)

    # decode / long-context decode
    GB, S = shape.global_batch, shape.seq_len
    caches = init_caches(cfg, GB, S, cache_dtype=torch.bfloat16,
                         device="meta")
    token = _meta((GB,), torch.int32)
    lengths = _meta((GB,), torch.int32)
    fn = make_decode_step(cfg, device=device)
    return Cell(arch, shape_name, "decode", fn,
                (params, token, caches, lengths),
                (pspec, Spec(b), cache_specs(mesh, cfg, caches), Spec(b)),
                **common)


def iter_cells():
    """All assigned (arch, shape) pairs with skip annotations."""
    from ..configs import ARCHS

    for arch, cfg in ARCHS.items():
        for shape_name, shape in SHAPES.items():
            yield arch, shape_name, skip_reason(cfg, shape)
