"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, held
to its own invariants: the reference's dry run fails under the
installed jax (its ``constrain`` refuses ``Explicit`` mesh axes), so
its numbers cannot be the yardstick.

* the CLI gate, with the reference test's asserts
  (``tests/test_distributed.py``): one cell on the 16 x 16 production
  mesh, a fake process group of 256 ranks, meta tensors;
* counts at 3 layer units equal ``extrapolate`` of the 1- and 2-unit
  counts (the per-layer work is the same at every depth), on smoke
  configs over a (2, 2) mesh of a fake group of 4;
* the per-device FLOPs of qwen3-0.6b's smoke train step on that mesh
  (every dim divides 2) times 4 lie within 1 % of a one-rank mesh's,
  and so do granite-moe-3b-a800m's; mamba2-130m's decode step lies
  above an even split by the work its Mamba2 path repeats over
  ``model``, which its record's ``note`` states;
* a DTensor redistribution's collectives reach the collective log with
  their local sizes, and a spec's placements follow its axes.

Every piece runs in a subprocess: a process group lives as long as its
process.  Marked ``slow`` as the reference's dry-run test is."""
import json
import os
import subprocess
import sys

import pytest

from _torch_dist import ROOT

pytestmark = pytest.mark.slow

ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}

#: Cells whose per-device counts on a (2, 2) mesh are held against a
#: one-rank mesh's: dense (every dim divides 2), moe (the expert products
#: split over ``model``; the dispatch repeats there), ssm (the Mamba2
#: path repeats over ``model``: ``dryrun.REPEATED_OVER_MODEL``).
SPLIT_CELLS = (("qwen3-0.6b", "train_4k"),
               ("granite-moe-3b-a800m", "train_4k"),
               ("mamba2-130m", "decode_32k"))

PROBE = f"SPLIT_CELLS = {SPLIT_CELLS!r}\n" + """
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import ARCHS, SHAPES, smoke
from repro_torch.distributed.sharding import Spec, placements
from repro_torch.launch.dryrun import _costs
from repro_torch.launch.mesh import init_fake_world
from repro_torch.launch.specs import build_cell, with_units
from repro_torch.roofline.analysis import CollectiveLog, extrapolate

def mesh_of(n, shape):
    init_fake_world(n)
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))

def costs(arch, shape, mesh, cfg):
    return _costs(build_cell(arch, shape, mesh, cfg_override=cfg,
                             microbatch_override=1))[0]

out = {"units": {}}
mesh = mesh_of(4, (2, 2))
for arch, shape in (("qwen3-0.6b", "train_4k"),
                    ("mamba2-130m", "prefill_32k")):
    cfg = smoke(ARCHS[arch]).replace(attn_impl="chunked")
    c = {u: costs(arch, shape, mesh, with_units(cfg, u, SHAPES[shape]))
         for u in (1, 2, 3)}
    out["units"][arch] = {"c3": c[3], "ex3": extrapolate(c[1], c[2], 3)}
t = distribute_tensor(torch.empty(8, 16, device="meta"), mesh,
                      [Shard(0), Replicate()])
with CollectiveLog() as log:
    t.redistribute(mesh, [Replicate(), Replicate()])
out["log"] = log.records
out["placements"] = [str(placements(Spec(("data", "model"), None), mesh)),
                     str(placements(Spec(None, "model"), mesh))]
out["split"] = {}
for arch, shape in SPLIT_CELLS:
    cfg = smoke(ARCHS[arch]).replace(attn_impl="chunked")
    out["split"][arch] = {
        "world4": costs(arch, shape, mesh_of(4, (2, 2)), cfg),
        "world1": costs(arch, shape, mesh_of(1, (1, 1)), cfg)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    r = subprocess.run([sys.executable, "-c", PROBE], env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dryrun_cli_gate(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "mamba2-130m", "--shape", "decode_32k",
         "--out", str(tmp_path)],
        env=ENV, cwd=ROOT, capture_output=True, text=True, timeout=400)
    assert "dry-run complete: 1 ok" in r.stdout, r.stdout + r.stderr[-2000:]
    rec = json.load(open(tmp_path / "mamba2-130m__decode_32k__16x16.json"))
    assert rec["status"] == "ok"
    assert rec["flops_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["n_chips"] == 256
    assert set(rec["memory_stats"]) == {"argument_size_in_bytes",
                                        "output_size_in_bytes",
                                        "temp_size_in_bytes"}
    assert "estimate" in rec["memory_estimate"]
    assert rec["coll_bytes_per_device"] > 0
    assert "repeated over the model axis" in rec["note"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_counts_extrapolate_linearly_in_units(probe, arch):
    c3, ex3 = probe["units"][arch]["c3"], probe["units"][arch]["ex3"]
    assert c3["flops"] > 0
    for k in c3:
        assert c3[k] == pytest.approx(ex3[k], rel=1e-6, abs=1.0), k


def test_flops_split_over_four_ranks(probe):
    dense = probe["split"]["qwen3-0.6b"]
    one, four = dense["world1"]["flops"], dense["world4"]["flops"]
    assert one > 0
    assert 4 * four == pytest.approx(one, rel=0.01)
    # one rank sends nothing
    assert all(v == 0 for k, v in dense["world1"].items()
               if k.startswith("coll:"))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m"])
def test_work_repeated_over_the_model_axis_is_measured(probe, arch):
    """The moe's FLOPs split over the 4 ranks within 1 % (its expert
    products split over ``model``; only the dispatch's memory work
    repeats there), while the ssm's per-device FLOPs lie above an even
    split, by the Mamba2 path run whole on both ``model`` ranks, yet
    at most half the whole (the data axis splits everything): the
    records of these families say so in their ``note``."""
    one = probe["split"][arch]["world1"]
    four = probe["split"][arch]["world4"]
    ratio = 4 * four["flops"] / one["flops"]
    if arch == "granite-moe-3b-a800m":
        assert ratio == pytest.approx(1.0, rel=0.01), ratio
    else:
        assert 1.05 < ratio <= 2.0, ratio
    assert 4 * four["bytes"] > one["bytes"]


def test_collective_log_sees_local_collectives(probe):
    # (8, 16) float32 sharded over data (2): the all-gather's local
    # result is the whole tensor, over a group of 2
    assert probe["log"] == [["all-gather", 8 * 16 * 4, 2]]
    assert probe["placements"] == ["[Shard(dim=0), Shard(dim=0)]",
                                   "[Replicate(), Shard(dim=1)]"]
