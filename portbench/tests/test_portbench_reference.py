"""The plain references against the port's ``interp_torch`` at small
sizes on the CPU (the test imports both; the references import nothing of
the port)."""
import math

import pytest
import torch

from portbench.reference import load
from repro_torch.core import ALL_PROGRAMS, compile_program

SHAPES = {"cosmo": [{"Nk": 3, "Nj": 9, "Ni": 13}, {"Nk": 2, "Nj": 24, "Ni": 40}],
          "hydro1d": [{"Nj": 5, "Ni": 9}, {"Nj": 16, "Ni": 64}]}
CASES = [(n, d) for n, ds in SHAPES.items() for d in ds]


def inputs(name, dims, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    if name == "cosmo":
        return {"u": torch.randn(dims["Nk"], dims["Nj"], dims["Ni"],
                                 generator=g, dtype=dtype)}
    x = torch.randn(2, dims["Nj"], dims["Ni"], generator=g, dtype=dtype)
    return {"mom": x[0], "rho": x[1] * x[1] + 1.0}


def port(name, arrays, dtype):
    gen = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu", dtype=dtype)
    return gen.fn(**arrays)


@pytest.mark.parametrize("name,dims", CASES, ids=str)
def test_float64_reference_matches_interp_torch_float64(name, dims):
    x = inputs(name, dims, 3, torch.float64)
    want = load(name).forward(x)
    got = port(name, x, torch.float64)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        torch.testing.assert_close(got[k].double(), want[k], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name,dims", CASES, ids=str)
def test_float32_port_within_rounding_of_the_reference(name, dims):
    x = inputs(name, dims, 4, torch.float32)
    ref = load(name)
    x64 = {k: v.double() for k, v in x.items()}
    want = ref.forward(x64)
    skip = ref.undecided(x64) if hasattr(ref, "undecided") else {}
    got = port(name, x, torch.float32)
    for k in want:
        diff = (got[k].double() - want[k])
        if k in skip:
            diff = diff.masked_fill(skip[k], 0.0)
        assert float(diff.norm()) <= 1e-6 * float(want[k].norm())


@pytest.mark.parametrize("name,dims", CASES, ids=str)
def test_outside_the_goal_region_is_zero(name, dims):
    x = inputs(name, dims, 5, torch.float64)
    out = next(iter(load(name).forward(x).values()))
    lo = 2
    inner = out[..., lo:-lo].clone()
    if name == "cosmo":
        assert not out[:, :lo].any() and not out[:, -lo:].any()
    assert not out[..., :lo].any() and not out[..., -lo:].any()
    assert torch.isfinite(inner).all() and inner.abs().sum() > 0


def test_hydro_ties_are_marked():
    """A pressure tie at one interface marks the two outputs that read
    its flux, and only those."""
    ref = load("hydro1d")
    rho = torch.full((1, 10), 2.0, dtype=torch.float64)
    mom = torch.arange(10, dtype=torch.float64).reshape(1, 10) * 0.5
    # pressures rise with |v|: strictly increasing, no ties ...
    assert not ref.undecided({"rho": rho, "mom": mom})["rnew"].any()
    # ... until two neighbours carry the same state
    mom[0, 5] = mom[0, 4]
    mask = ref.undecided({"rho": rho, "mom": mom})["rnew"][0]
    assert mask.nonzero().flatten().tolist() == [4, 5]


def test_hydro_tie_width_covers_float32_rounding():
    ref = load("hydro1d")
    assert ref.TIE_RTOL >= 10 * 5 * 2.0 ** -24
    assert ref.TIE_RTOL <= 1e-4
    assert math.isfinite(ref.TIE_RTOL)
