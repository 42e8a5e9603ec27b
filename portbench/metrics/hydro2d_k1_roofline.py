"""``hydro2d_k1_roofline`` (%): the least time the card needs for the
hydro2d steps completed in the traced sub-window over K1's profiled
device time in it.  A step's least time is the larger of its bytes at
the HBM rate (each input read once, each output written once) and the
reference's operations **once per grid point** at the float32 rate: the
step evaluates every kernel body once a point and writes four outputs
there, where ``run.least_s`` counts the operations once for each output
point.  None without K1 in the trace, on a card the yardstick does not
know, or at another grid than the cell's."""
import json
import pathlib

from . import _yardstick

_ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = _ROOT / "configs" / "hydro2d.json"
MIX = _ROOT / "traffic" / "step_hydro2d_10k.json"


def least_seconds(config: dict, dims: dict, flops_point: int,
                  device_name: str):
    """One step's least time on ``device_name`` (None on a card the
    yardstick does not know)."""
    pk = _yardstick.peaks(device_name)
    if pk is None:
        return None
    hbm, fp32 = pk
    grid = _yardstick.points(config, dims) // len(config["outputs"])
    return max(_yardstick.bytes_moved(config, dims) / hbm,
               flops_point * grid / fp32)


def read(run):
    t = run.trace
    if t is None or t.k1_s <= 0 or t.examples <= 0:
        return None
    import torch
    if not torch.cuda.is_available():
        return None
    from .. import reference
    config = json.loads(CONFIG.read_text())
    dims = json.loads(MIX.read_text())["dims"]
    if _yardstick.points(config, dims) != run.points:
        return None
    least = least_seconds(
        config, dims,
        _yardstick.flops_per_point(reference.load("hydro2d").BODIES),
        torch.cuda.get_device_name(0))
    if least is None:
        return None
    return t.examples * least / t.k1_s * 100.0
