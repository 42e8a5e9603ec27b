"""``courant_roofline`` (%): the least time of the Courant reductions
run in the traced sub-window (each reads its four fields once, at the
HBM rate) over their own profiled K1 device time.  The reductions are
the K1 launches of the kernel named :data:`KERNEL`, the name the trace
prints for the Courant program's source, whose parameter block
(``Params<NP, ND, T>``: pointers and integers) differs from the sweeps'.
One reduction runs for every two steps (every pair of the march).  None
without such a launch in the trace, on a card the yardstick does not
know, or at another grid than the cell's."""
from . import hydroc_k1_roofline

#: The Courant program's K1 kernel in float32, as the trace names it.
KERNEL = "hfav_kernel(hfav::Params<7, 24, float>)"


def read(run):
    found = hydroc_k1_roofline.cell(run)
    if found is None:
        return None
    config, dims, name = found
    spent = run.trace.by_name.get(KERNEL, 0.0)
    launches = run.trace.examples // 2
    least = hydroc_k1_roofline.courant_least_seconds(config, dims, name)
    if spent <= 0 or launches <= 0 or least is None:
        return None
    return launches * least / spent * 100.0
