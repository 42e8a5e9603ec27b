"""The port's roofline analysis and report against the reference's.

``extrapolate``, ``model_flops_for`` and ``Roofline`` are the
reference's with only the constants swapped (the H100's for the TPU
v5e's), so each is held against the reference's function on the same
inputs, the reference's constants patched to the port's.  The port
records collectives instead of parsing XLA HLO: the records'
ring-convention bytes are held against the reference's
``collective_bytes`` on HLO lines written to describe the same
collectives.  The report tables are held row by row (the headers name
the port's counts)."""
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch.specs import iter_cells as jax_iter_cells
from repro.roofline import analysis as ref
from repro.roofline import report as ref_report
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.specs import iter_cells
from repro_torch.roofline import analysis, report


@pytest.fixture
def h100_reference(monkeypatch):
    monkeypatch.setattr(ref, "PEAK_FLOPS", analysis.PEAK_FLOPS)
    monkeypatch.setattr(ref, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ref, "ICI_BW", analysis.NVLINK_BW)


def test_constants_are_the_h100_sxm_data_sheets():
    assert analysis.PEAK_FLOPS == 989e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.NVLINK_BW == 450e9


@pytest.mark.parametrize("seed", range(6))
def test_extrapolate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    keys = ["flops", "bytes", "coll:all-gather", "coll:all-reduce"]
    c1 = {k: float(rng.uniform(0, 1e12)) for k in keys}
    # some keys grow, some shrink (clamped at the 1-unit cost), one is
    # missing from the 2-unit point
    c2 = {k: c1[k] * float(rng.uniform(0.5, 3.0)) for k in keys[:-1]}
    units = int(rng.integers(1, 100))
    assert analysis.extrapolate(c1, c2, units) == \
        ref.extrapolate(c1, c2, units)


def test_model_flops_for_every_cell_matches_reference():
    cells = list(iter_cells())
    assert cells == list(jax_iter_cells())
    for arch, shape, _ in cells:
        for active in (True, False):
            assert analysis.model_flops_for(
                ARCHS[arch], SHAPES[shape], active=active) == \
                ref.model_flops_for(JAX_ARCHS[arch], JAX_SHAPES[shape],
                                    active=active), (arch, shape, active)


@pytest.mark.parametrize("seed", range(6))
def test_roofline_to_dict_matches_reference(seed, h100_reference):
    rng = np.random.default_rng(seed)
    kw = dict(arch="qwen3-0.6b", shape="train_4k", mesh="16x16",
              n_chips=int(rng.choice([1, 256, 512])),
              flops_per_device=float(rng.uniform(0, 1e15)),
              bytes_per_device=float(rng.uniform(0, 1e12)),
              coll_bytes_per_device=float(rng.uniform(0, 1e11)),
              coll_breakdown={"all-gather": 1.0},
              model_flops=float(rng.uniform(0, 1e17)),
              memory_stats={"argument_size_in_bytes": 7})
    got = analysis.Roofline(**kw).to_dict()
    want = ref.Roofline(**kw).to_dict()
    assert got == want
    assert got["bottleneck"] in ("compute", "memory", "collective")


#: (HLO line, the record the port keeps for the same collective).
HLO_RECORDS = [
    ("%ag = bf16[256,4096]{1,0} all-gather(bf16[16,4096]{1,0} %p), "
     "replica_groups=[16,16]<=[256], dimensions={0}",
     ("all-gather", 256 * 4096 * 2, 16)),
    ("%ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), "
     "replica_groups={{0,1,2,3}}, to_apply=%add",
     ("all-reduce", 1024 * 4, 4)),
    ("%ags = (bf16[8,64]{1,0}, bf16[128,64]{1,0}) all-gather-start("
     "bf16[8,64]{1,0} %q), replica_groups=[16,16]<=[256]",
     ("all-gather", 8 * 64 * 2 + 128 * 64 * 2, 16)),
    ("%agd = bf16[128,64]{1,0} all-gather-done(%ags)", None),
    ("%rs = f32[64,32]{1,0} reduce-scatter(f32[1024,32]{1,0} %g), "
     "replica_groups=[16,16]<=[256], dimensions={0}",
     ("reduce-scatter", 64 * 32 * 4, 16)),
    ("%a2a = bf16[4,128]{1,0} all-to-all(bf16[4,128]{1,0} %t), "
     "replica_groups={{0,1}}",
     ("all-to-all", 4 * 128 * 2, 2)),
    ("%cp = f32[12,16]{1,0} collective-permute(f32[12,16]{1,0} %y), "
     "source_target_pairs={{0,1},{1,2},{2,3}}",
     ("collective-permute", 12 * 16 * 4, 4)),
    ("%ar2 = f32[] all-reduce(f32[] %s), replica_groups=[1,512]<=[512]",
     ("all-reduce", 4, 512)),
]


@pytest.mark.parametrize("i", range(len(HLO_RECORDS)))
def test_collective_ring_conventions_match_reference(i):
    line, rec = HLO_RECORDS[i]
    got = analysis.collective_bytes([rec] if rec else [])
    assert got == ref.collective_bytes(line)


def test_collective_records_sum_as_reference_hlo():
    text = "\n".join(line for line, _ in HLO_RECORDS)
    got = analysis.collective_bytes([r for _, r in HLO_RECORDS if r])
    assert got == ref.collective_bytes(text)


def test_collective_log_records_sends():
    with analysis.CollectiveLog() as log:
        analysis.record("collective-permute", 64, 4)
    analysis.record("collective-permute", 64, 4)  # no log active
    assert log.records == [("collective-permute", 64, 4)]
    with pytest.raises(ValueError):
        analysis.record("broadcast", 1, 2)


def _records() -> list:
    ok = analysis.Roofline(
        arch="qwen3-0.6b", shape="train_4k", mesh="16x16", n_chips=256,
        flops_per_device=3.2e13, bytes_per_device=1.1e12,
        coll_bytes_per_device=4e10, model_flops=5e15,
        memory_stats={"argument_size_in_bytes": 2_000_000_000,
                      "temp_size_in_bytes": 500_000_000}).to_dict()
    ok["status"] = "ok"
    fast = dict(ok, shape="decode_32k", t_compute=2e-4, t_memory=5e-7,
                t_collective=3e-3, bottleneck="collective")
    multi = dict(ok, mesh="2x16x16", n_chips=512)
    return [ok, fast, multi,
            {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
             "status": "skipped", "reason": "full attention at 524288-token "
             "decode has no sub-quadratic path"},
            {"arch": "mamba2-130m", "shape": "prefill_32k", "mesh": "16x16",
             "status": "error", "error": "RuntimeError: boom"}]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_roofline_table_matches_reference(mesh):
    got = report.roofline_table(_records(), mesh).splitlines()
    want = ref_report.roofline_table(_records(), mesh).splitlines()
    assert len(got) == len(want) > 2
    assert got[2:] == want[2:]


def test_dryrun_table_matches_reference():
    got = report.dryrun_table(_records()).splitlines()
    want = ref_report.dryrun_table(_records()).splitlines()
    assert len(got) == len(want) == 7
    assert got[2:] == want[2:]


def test_load_records_reads_a_directory(tmp_path):
    import json

    for i, r in enumerate(_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert report.load_records(str(tmp_path)) == \
        ref_report.load_records(str(tmp_path))
