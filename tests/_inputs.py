"""Physical draws for the port's own HydroC programs (``hydro2d``,
``hydroc``, ``courant``) in the tests that draw every program's inputs
from a standard normal: the density is made ``x * x + 1`` and the total
energy ``x * x + 20`` (a positive internal energy at all but about
``e**-20`` of the points), as the hydro2d benchmark draws them, and
``hydroc``'s scalar ``dtdx`` ``0.05 + x * x / 100`` (a Courant-limited
step over those states); a density or an energy near zero sends the gas
to the solver's floors, where float32 and float64 part."""

HYDRO = ("hydro2d", "hydroc", "courant")


def hydro2d_state(name: str, array: str, a):
    """``a`` (a standard normal draw of ``array``, any array type) as
    program ``name`` takes it."""
    if name not in HYDRO:
        return a
    if array == "rho":
        return a * a + 1.0
    if array == "E":
        return a * a + 20.0
    if array == "dtdx":
        # in place: a 0-dim numpy array's arithmetic gives a numpy scalar
        a *= a
        a *= 0.01
        a += 0.05
    return a
