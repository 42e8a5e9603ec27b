"""The cards' peak rates by name, from NVIDIA's data sheets: the one
table the roofline (:mod:`repro_torch.roofline.analysis`) and the
kernels' measurements (:mod:`repro_torch.kernels.stencil2d.bench`,
:mod:`repro_torch.serve.bench`) read.

Each table lists ``(name part, rate)``, the most specific part first: a
card takes the rate of the first part its name contains (the name
``torch.cuda.get_device_name`` and ``nvidia-smi`` report), so the H100
SXM, ``"NVIDIA H100 80GB HBM3"``, takes the rows of ``"H100"``.
"""
from __future__ import annotations

#: The card the roofline's constants describe (the H100 SXM5).
H100_SXM = "NVIDIA H100 80GB HBM3"
#: Device-memory rates (bytes/s).
HBM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
            ("H100", 3.35e12))
#: Dense bf16 tensor-core peaks (FLOP/s; the H100 SXM figure assumes its
#: 700 W limit).
BF16_PEAK = (("H200", 989e12), ("H100 NVL", 835e12), ("H100 PCIe", 756e12),
             ("H100", 989e12))
#: float32 peaks outside the tensor cores (FLOP/s).
F32_PEAK = (("H200", 67e12), ("H100 NVL", 60e12), ("H100 PCIe", 51e12),
            ("H100", 67e12))
#: Dense TF32 tensor-core peaks (FLOP/s; half the sparse figures the
#: sheets print).
TF32_PEAK = (("H200", 495e12), ("H100 NVL", 418e12), ("H100 PCIe", 378e12),
             ("H100", 495e12))


def rate(table, name: str) -> float:
    """The rate in ``table`` of the card named ``name``; raises for a card
    the table lacks."""
    for key, value in table:
        if key in name:
            return value
    raise RuntimeError(f"no rate known for {name!r}")
