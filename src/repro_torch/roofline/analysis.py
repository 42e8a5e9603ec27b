"""Roofline terms of a dry-run cell (the port of
``repro.roofline.analysis``).

Constants are the NVIDIA H100 SXM5 data sheet's:

* ``PEAK_FLOPS`` 989e12 FLOP/s: dense bf16 on the tensor cores, per GPU
  (the sheet's 1979 TFLOP/s is with 2:4 sparsity);
* ``HBM_BW`` 3.35e12 B/s: HBM3, per GPU;
* ``NVLINK_BW`` 450e9 B/s: NVLink 4, per GPU and per direction.  A GPU
  has 18 links of 25 GB/s each way, 900 GB/s both ways together; a ring
  collective sends each byte in one direction, so the per-direction
  figure of the whole GPU is the rate its traffic below is divided by.
  It takes the place of the reference's per-link ICI rate.

An NVLink domain (one HGX H100 board, through its NVSwitches) holds 8
GPUs.  The production mesh's 16-wide ``model`` axis therefore spans two
domains, whose traffic crosses the slower inter-node network; that is
not modelled: every collective is charged at ``NVLINK_BW``.

Costs are per device, as the reference's: ``flops`` and ``bytes`` are
what one rank computes and moves (``repro_torch.launch.dryrun`` counts
them on the local shards of its DTensors).  XLA's HLO has no
counterpart here, so collectives are *records*: one
``(kind, result bytes, group size)`` per functional collective
(``torch.ops._c10d_functional.*``, which DTensor's redistributions
issue) or point-to-point send, kept by a :class:`CollectiveLog` while
it is active.  :func:`collective_bytes`
applies the reference's ring conventions to them unchanged.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Iterable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per GPU (H100 SXM5)
HBM_BW = 3.35e12  # bytes/s per GPU (HBM3)
NVLINK_BW = 450e9  # bytes/s per GPU per direction (NVLink 4, 18 links)

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: ``torch.ops._c10d_functional`` op names and the collective each is.
FUNCTIONAL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

#: The logs being written to: :func:`record` appends to each.
_ACTIVE: list["CollectiveLog"] = []


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    return sum(_nbytes(o) for o in out)


def _group_size(args) -> int:
    """The size of the group a functional collective names (its last
    string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class CollectiveLog(TorchDispatchMode):
    """The collectives issued while it is active (``with log:``), as
    ``(kind, result bytes, group size)`` records: every functional
    collective that reaches the dispatcher on a plain tensor (a DTensor
    op passes through, so the local collectives its redistribution
    issues are seen with their local sizes), and every :func:`record`
    call (the pipeline's sends)."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[tuple[str, int, int]] = []

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            kind = FUNCTIONAL_KIND.get(func._overloadpacket.__name__)
            if kind is not None:
                self.records.append((kind, _nbytes(out), _group_size(args)))
        return out


def record(kind: str, result_bytes: int, group_size: int) -> None:
    """Note one collective in every active :class:`CollectiveLog`."""
    if kind not in _COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    for log in _ACTIVE:
        log.records.append((kind, int(result_bytes), int(group_size)))


def collective_bytes(records: Iterable[tuple[str, int, int]],
                     default_group: int = 1) -> dict[str, float]:
    """Per-device *link traffic* bytes of each collective kind.

    Each record is ``(kind, result bytes, group size g)``; a ``g`` below
    1 takes ``default_group``.  The reference's ring conventions:

        all-gather         result * (g-1)/g
        all-reduce         2 * result * (g-1)/g
        reduce-scatter     result * (g-1)        (operand = g * result)
        all-to-all         result * (g-1)/g
        collective-permute result

    A point-to-point send is a collective-permute, recorded once, by the
    sender."""
    out: dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    for kind, result, g in records:
        g = g if g >= 1 else max(1, default_group)
        if kind == "all-gather":
            out[kind] += result * (g - 1) / g
        elif kind == "all-reduce":
            out[kind] += 2.0 * result * (g - 1) / g
        elif kind == "reduce-scatter":
            out[kind] += result * (g - 1)
        elif kind == "all-to-all":
            out[kind] += result * (g - 1) / g
        elif kind == "collective-permute":
            out[kind] += result
        else:
            raise ValueError(f"unknown collective {kind!r}")
    return out


def extrapolate(cost1: dict, cost2: dict, units: int) -> dict:
    """Linear per-layer-unit extrapolation: total(u) = c1 + (u-1)*(c2-c1).
    Applied to flops / bytes / per-collective traffic from the 1-unit and
    2-unit counted runs."""
    out = {}
    for k in cost1:
        c1 = float(cost1.get(k, 0.0))
        c2 = float(cost2.get(k, c1))
        # clamp below at the 1-unit cost: a total below one layer's cost
        # is impossible
        out[k] = max(c1 + (units - 1) * (c2 - c1), c1)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0  # 6*N*D (or 6*N_active*D)
    memory_stats: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term bound spent on useful model flops:
        (model_flops / chips / peak) / max(term)."""
        t_use = self.model_flops / self.n_chips / PEAK_FLOPS
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        return t_use / t_dom if t_dom else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def model_flops_for(cfg, shape, *, active: bool = True) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference-ish steps."""
    n = cfg.n_active_params() if active else cfg.n_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analyze(arch: str, shape_name: str, mesh_name: str, n_chips: int,
            cost: dict, collectives: Iterable[tuple[str, int, int]],
            memory_stats: dict, cfg, shape) -> Roofline:
    """The reference's ``analyze`` with the collective records in place
    of HLO text; ``cost`` has ``flops`` and ``bytes accessed``."""
    coll = collective_bytes(collectives)
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, n_chips=n_chips,
        flops_per_device=float(cost.get("flops", 0.0)),
        bytes_per_device=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_device=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops=model_flops_for(cfg, shape),
        memory_stats=memory_stats,
    )
