"""The mesh context's layout helpers for torch 2.11's DTensor rules:
``flat_ready`` (a dim sharded behind the first of a group an op
flattens is made whole) and ``tied`` (a tied weight's second use gives
its gradient back in the weight's layout).  Each acts only where the
installed DTensor refuses the op (``ctx.refuses``, a probe on empty meta
tensors), so a dry run's counts do not change where it does not.
Without a mesh both return their input itself; on a (2, 2) mesh of a
fake process group (meta tensors, in a subprocess: a process group lives
as long as its process) they are inert where this torch's DTensor copes,
and, with a refusal forced, change a layout only where the rule needs
it and record it for the dry run's note."""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.distributed import ctx

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "CUDA_VISIBLE_DEVICES": ""}


@pytest.mark.parametrize("fn", ["flat_ready", "tied"])
def test_no_mesh_returns_the_input_itself(fn):
    assert ctx.active_mesh() is None
    x = torch.randn(4, 1, 6, 2, 8, requires_grad=True)
    if fn == "flat_ready":
        assert ctx.flat_ready(x, (0, 2), (3, 1), what="w") is x
    else:
        assert ctx.tied(x) is x
    assert not ctx.LAYOUT_CHANGES


PROBE = """
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor import DTensor
from repro_torch.distributed import ctx
from repro_torch.launch.mesh import init_fake_world

init_fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}

def dt(shape, placements, grad=False):
    # a DTensor of global ``shape`` (each shard over a 2-wide axis)
    local = list(shape)
    for p in placements:
        if p.is_shard():
            local[p.dim] //= 2
    t = torch.empty(local, device="meta")
    d = DTensor.from_local(t, mesh, placements, run_check=False,
                           shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    return d.detach().requires_grad_(grad)

def kinds(placements):
    return ["S%d" % p.dim if p.is_shard() else "P" if p.is_partial() else "R"
            for p in placements]

with ctx.use_mesh(mesh):
    refuses = {op: ctx.refuses(op, mesh) for op in ("flatten", "add")}
    out["refuses"] = refuses
    q = dt((4, 1, 8, 1, 16), [Shard(2), Partial()])
    w = dt((32, 16), [Shard(1), Replicate()], grad=True)
    out["inert"] = [
        refuses["flatten"] or ctx.flat_ready(q, (0, 2), what="x") is q,
        refuses["add"] or ctx.tied(w) is w]
    # as under torch 2.11
    ctx._REFUSES.update({(op, (2, 2)): True for op in ("flatten", "add")})
    # (B, Sq, KVH, group, D): heads sharded over data, partial over model
    q = dt((4, 1, 8, 1, 16), [Shard(2), Partial()])
    r = ctx.flat_ready(q, (0, 2), (3, 1), what="heads")
    out["behind"] = kinds(r.placements)
    out["noted"] = sorted(ctx.LAYOUT_CHANGES)
    ctx.LAYOUT_CHANGES.clear()
    # batch sharded (the leading dim of its group), the rest alone
    q = dt((4, 1, 8, 1, 16), [Shard(0), Shard(4)])
    out["leading_same"] = ctx.flat_ready(q, (0, 2), (3, 1), what="x") is q
    out["leading_noted"] = sorted(ctx.LAYOUT_CHANGES)

    # a tied table (V, d) sharded on d over data; its head use's
    # gradient arrives partial over data
    w = dt((32, 16), [Shard(1), Replicate()], grad=True)
    x = dt((8, 16), [Shard(0), Replicate()])
    head = ctx.tied(w).T
    (g,) = torch.autograd.grad((x @ head).sum(), w)
    out["tied_grad"] = kinds(g.placements)
    out["table"] = kinds(w.placements)
    out["tied_noted"] = sorted(ctx.LAYOUT_CHANGES)
    ctx.LAYOUT_CHANGES.clear()
    with torch.no_grad():
        out["tied_no_grad_same"] = ctx.tied(w) is w
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    r = subprocess.run([sys.executable, "-c", PROBE], env=ENV, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_helpers_are_inert_where_dtensor_copes(probe):
    assert probe["inert"] == [True, True], probe["refuses"]
    # the mesh of one rank a card runs: nothing to probe, nothing to do
    assert ctx.refuses("flatten", _Mesh1()) is False


class _Mesh1:
    ndim = 2

    def size(self, i):
        return 1


def test_flat_ready_makes_a_dim_behind_its_group_whole(probe):
    assert probe["behind"] == ["R", "P"]
    assert probe["noted"] == ["heads"]


def test_flat_ready_leaves_a_leading_shard_alone(probe):
    assert probe["leading_same"] is True
    assert probe["leading_noted"] == []


def test_tied_weight_gradient_comes_back_in_its_layout(probe):
    assert probe["tied_grad"] == probe["table"] == ["S1", "R"]
    assert len(probe["tied_noted"]) == 1
    assert "tied LM head" in probe["tied_noted"][0]
    assert probe["tied_no_grad_same"] is True
