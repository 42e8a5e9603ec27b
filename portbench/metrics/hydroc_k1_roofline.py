"""``hydroc_k1_roofline`` (%): the least time the card needs for the
HydroC steps completed in the traced sub-window over all of K1's profiled
device time in it (the sweeps and the Courant reductions).  A step's
least time is the reference's operations of one split step **once per
grid point** at the float32 rate, plus half a Courant reduction's bytes
(its four fields read once; one reduction every second step) at the HBM
rate.  None without K1 in the trace, on a card the yardstick does not
know, or at another grid than the cell's.

The functions that count a step's and a reduction's least time live
here; ``courant_roofline`` takes them."""
import json
import math
import pathlib

from . import _yardstick

_ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = _ROOT / "configs" / "hydroc.json"
MIX = _ROOT / "traffic" / "march_hydroc_sedov_10k.json"


def courant_bytes(config: dict, dims: dict) -> int:
    """A Courant reduction's bytes: each input array read once."""
    return sum(math.prod(_yardstick.shape(a["dims"], dims))
               for a in config["inputs"].values()) \
        * _yardstick.ITEMSIZE[config["dtype"]]


def courant_least_seconds(config: dict, dims: dict, device_name: str):
    pk = _yardstick.peaks(device_name)
    if pk is None:
        return None
    return courant_bytes(config, dims) / pk[0]


def step_least_seconds(config: dict, dims: dict, flops_point: int,
                       device_name: str):
    """One step's least time on ``device_name`` (None on a card the
    yardstick does not know): its operations once a grid point, and half
    a Courant reduction."""
    pk = _yardstick.peaks(device_name)
    if pk is None:
        return None
    grid = _yardstick.points(config, dims) // len(config["outputs"])
    return flops_point * grid / pk[1] \
        + 0.5 * courant_least_seconds(config, dims, device_name)


def cell(run):
    """``(config, dims, card name)`` when ``run`` traced the cell's grid
    on a card, else None."""
    t = run.trace
    if t is None or t.examples <= 0:
        return None
    import torch
    if not torch.cuda.is_available():
        return None
    config = json.loads(CONFIG.read_text())
    dims = json.loads(MIX.read_text())["dims"]
    if _yardstick.points(config, dims) != run.points:
        return None
    return config, dims, torch.cuda.get_device_name(0)


def read(run):
    found = cell(run)
    if found is None or run.trace.k1_s <= 0:
        return None
    from .. import reference
    config, dims, name = found
    least = step_least_seconds(
        config, dims,
        _yardstick.flops_per_point(reference.load("hydroc").BODIES), name)
    if least is None:
        return None
    return run.trace.examples * least / run.trace.k1_s * 100.0
