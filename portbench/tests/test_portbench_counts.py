"""The yardstick's counts against hand counts."""
import json

import pytest

from portbench.harness import ROOT
from portbench.metrics import _yardstick as y
from portbench.reference import load


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name,flops", [
    # ulap: 3 adds, 4*c, the subtraction; each flux: l1-l0, u1-u0, the
    # product, the comparison; ustage: two differences, their sum, 0.1*,
    # the subtraction from c
    ("cosmo", 5 + 4 + 4 + 5),
    # constoprim 1; eos 5; slope: dl, dr, dl*dr, > 0, 2*dl, *dr, dl+dr,
    # +1e-30, /; trace 4; riemann's comparison 1; cmpflx 1; update 3
    ("hydro1d", 1 + 5 + 9 + 4 + 1 + 1 + 3),
])
def test_flops_per_point(name, flops):
    assert y.flops_per_point(load(name).BODIES) == flops


@pytest.mark.parametrize("name,dims,points,nbytes", [
    ("cosmo", {"Nk": 80, "Nj": 774, "Ni": 1158},
     80 * 770 * 1154, 2 * 80 * 774 * 1158 * 4),
    ("cosmo", {"Nk": 60, "Nj": 390, "Ni": 582},
     60 * 386 * 578, 2 * 60 * 390 * 582 * 4),
    ("hydro1d", {"Nj": 8192, "Ni": 8192},
     8192 * 8188, 3 * 8192 * 8192 * 4),
    ("hydro1d", {"Nj": 4096, "Ni": 4096},
     4096 * 4092, 3 * 4096 * 4096 * 4),
])
def test_points_and_bytes(name, dims, points, nbytes):
    cfg = config(name)
    assert y.points(cfg, dims) == points
    assert y.bytes_moved(cfg, dims) == nbytes


@pytest.mark.parametrize("card,want", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 67e12)),
    # other H100s and the H200 share a part of the name and none of the
    # rates: no cell runs on them, so they read no peak
    ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA H200", None),
])
def test_peaks_by_card_name(card, want):
    assert y.peaks(card) == want


def test_unknown_card_has_no_peak():
    assert y.peaks("NVIDIA A100-SXM4-80GB") is None
    assert y.least_seconds(config("cosmo"), {"Nk": 2, "Nj": 8, "Ni": 8},
                           18, "cpu") is None


def test_least_seconds_is_the_byte_bound_on_the_h100():
    cfg = config("cosmo")
    dims = {"Nk": 80, "Nj": 774, "Ni": 1158}
    least = y.least_seconds(cfg, dims, 18, "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(2 * 80 * 774 * 1158 * 4 / 3.35e12)
    # the stencils are bound by bytes: 18 operations a point take 11 % of it
    assert 18 * y.points(cfg, dims) / 67e12 < 0.2 * least
