"""The port's front end (inference, grouping, fusion, storage
contraction) reproduces the reference's schedule and storage plan on
every program of the reference: nest count, storage kind per variable,
and leads."""
import pytest

from repro.core.dataflow import build_dataflow as ref_dataflow
from repro.core.fusion import fuse_inest_dag as ref_fuse
from repro.core.infer import infer as ref_infer
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro.core.reuse import analyze_storage as ref_storage
from repro_torch.core.dataflow import build_dataflow
from repro_torch.core.fusion import fuse_inest_dag
from repro_torch.core.infer import infer
from repro_torch.core.programs import ALL_PROGRAMS, PORT_ONLY
from repro_torch.core.reuse import analyze_storage


def test_same_program_corpus():
    """The port holds the reference's programs and its own
    (``PORT_ONLY``), which the reference lacks."""
    assert set(ALL_PROGRAMS) - set(PORT_ONLY) == set(REF_PROGRAMS)
    assert not set(PORT_ONLY) & set(REF_PROGRAMS)


@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_schedule_and_storage_match_reference(name):
    ref = ref_storage(ref_fuse(ref_dataflow(ref_infer(REF_PROGRAMS[name]()))))
    got = analyze_storage(fuse_inest_dag(build_dataflow(
        infer(ALL_PROGRAMS[name]()))))
    assert len(got.nests) == len(ref.nests)
    assert got.schedule.n_toplevel() == ref.schedule.n_toplevel()
    assert got.schedule.pretty() == ref.schedule.pretty()
    assert {v.name: v.kind for v in got.vars.values()} == \
        {v.name: v.kind for v in ref.vars.values()}
    assert got.summary() == ref.summary()
    assert [n.leads for n in got.nests] == [n.leads for n in ref.nests]
    assert got.nest_of_gid == ref.nest_of_gid
