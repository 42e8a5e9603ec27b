"""``hydroc_aux_us`` (us): profiled device time outside K1's kernel (the
ghost frame's refill, the Courant program's 0-dim ``dtdx`` step) per
HydroC step completed in the traced sub-window.  None without a trace or
at another grid than the cell's."""
import json

from . import _yardstick, hydroc_k1_roofline


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.examples <= 0:
        return None
    config = json.loads(hydroc_k1_roofline.CONFIG.read_text())
    dims = json.loads(hydroc_k1_roofline.MIX.read_text())["dims"]
    if _yardstick.points(config, dims) != run.points:
        return None
    return t.other_s / t.examples * 1e6
