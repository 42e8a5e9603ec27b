"""The port's planner reproduces the golden plan corpus byte for byte
(apart from the module of the kernel bodies), and
``from_reference_dict`` turns the JAX package's serialized plans into
the same validated port plans."""
import json

import pytest

from repro.core.dataflow import build_dataflow as ref_dataflow
from repro.core.fusion import fuse_inest_dag as ref_fuse
from repro.core.infer import infer as ref_infer
from repro.core.codegen_pallas import plan_pallas as ref_plan_pallas
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro.core.reuse import analyze_storage as ref_storage
from repro_torch.core.dataflow import build_dataflow
from repro_torch.core.fusion import fuse_inest_dag
from repro_torch.core.infer import infer
from repro_torch.core.plan import (PORT_PROGRAMS, REFERENCE_PROGRAMS,
                                   KernelPlan, from_reference_dict)
from repro_torch.core.planner import plan_pallas
from repro_torch.core.programs import ALL_PROGRAMS, PORT_ONLY
from repro_torch.core.reuse import analyze_storage

from _goldens import GOLDEN_DIR, PORT_GOLDEN_DIR, golden_path


def _plan(name) -> KernelPlan:
    idag = infer(ALL_PROGRAMS[name]())
    return plan_pallas(analyze_storage(fuse_inest_dag(build_dataflow(idag))),
                       idag)


def _golden_text(kplan: KernelPlan) -> str:
    """The plan serialized as ``scripts/warm_cache.py --goldens`` writes
    it, with the port's body module named as the reference's (the
    port's own programs keep theirs)."""
    text = json.dumps(kplan.to_dict(), indent=1, sort_keys=True) + "\n"
    return text.replace(f'"module": "{PORT_PROGRAMS}"',
                        f'"module": "{REFERENCE_PROGRAMS}"')


def _module(name) -> str:
    """The module of ``name``'s kernel bodies."""
    return ALL_PROGRAMS[name].__module__


def test_golden_corpus_covers_every_program():
    assert {p.stem for p in GOLDEN_DIR.glob("*.json")} == set(REF_PROGRAMS)
    assert {p.stem for p in PORT_GOLDEN_DIR.glob("*.json")} == \
        set(PORT_ONLY)


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_planner_reproduces_golden_bytes(name):
    kplan = _plan(name)
    assert _golden_text(kplan) == golden_path(name).read_text()
    assert f'"module": "{_module(name)}"' in json.dumps(kplan.to_dict())


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_from_reference_dict_round_trips_golden(name):
    golden = json.loads(golden_path(name).read_text())
    kplan = from_reference_dict(golden)
    assert kplan == _plan(name)
    assert kplan.cache_key() == _plan(name).cache_key()
    for call in kplan.calls:
        for fn in call.fns:
            assert getattr(fn, "_plan_base_fn", fn).__module__ == \
                _module(name)
    assert _golden_text(kplan) == golden_path(name).read_text()


@pytest.mark.parametrize("name", ["row_sum", "normalization", "cosmo"])
def test_from_reference_dict_takes_a_live_reference_plan(name):
    """A dict straight from the JAX package's ``KernelPlan.to_dict()``
    (``with_init`` wrappers included) re-links onto the port's bodies."""
    idag = ref_infer(REF_PROGRAMS[name]())
    ref = ref_plan_pallas(ref_storage(ref_fuse(ref_dataflow(idag))), idag)
    kplan = from_reference_dict(ref.to_dict())
    assert kplan == _plan(name)
    assert kplan.cache_key() == _plan(name).cache_key()
