"""Physical draws for the port's own hydro2d program in the tests that
draw every program's inputs from a standard normal: its density is made
``x * x + 1`` and its total energy ``x * x + 20`` (a positive internal
energy at all but about ``e**-20`` of the points), as the benchmark
draws them; a density or an energy near zero sends the gas to the
solver's floors, where float32 and float64 part."""


def hydro2d_state(name: str, array: str, a):
    """``a`` (a standard normal draw of ``array``, any array type) as
    program ``name`` takes it."""
    if name != "hydro2d":
        return a
    if array == "rho":
        return a * a + 1.0
    if array == "E":
        return a * a + 20.0
    return a
