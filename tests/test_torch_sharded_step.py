"""The port's sharded train step and its mesh context.

minitron-4b's smoke step (and granite-moe-3b-a800m's and mamba2-130m's)
on a (2, 2) ``("data", "model")`` mesh of 4
gloo CPU ranks, parameters and AdamW moments laid out by
``param_specs`` (``fsdp_tp``) and the batch over ``data``, against the
port's unsharded step and the reference's unsharded ``jax.jit`` step
from the same parameters and batch, at the reference test's tolerances
(``tests/test_distributed.py``: loss ``rtol=1e-5``, parameters
``atol=3e-5, rtol=1e-3``).  The reference's own sharded step cannot be
run under the installed jax (its ``constrain`` refuses ``Explicit``
mesh axes), so the unsharded steps are the references.

With no mesh active, the context's functions return their input object
itself, so every unsharded run is unchanged."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.models import init_params as jax_init_params
from repro.optim.adamw import AdamWCfg as JaxAdamWCfg
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, smoke
from repro_torch.distributed import ctx
from repro_torch.models import params_from_jax
from repro_torch.tree import tree_leaves

#: The reference test's architecture (dense), and the moe and ssm
#: families, whose dispatch and SSD projection take ``distributed.ctx``'s
#: per-shard routes under a mesh.
ARCHS_TESTED = ["minitron-4b", "granite-moe-3b-a800m", "mamba2-130m"]
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=3e-5, rtol=1e-3)

RANK_CODE = """
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS, smoke
from repro_torch.distributed.ctx import use_mesh
from repro_torch.distributed.sharding import Spec, distribute, param_specs
from repro_torch.optim.adamw import AdamWCfg, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map
state = torch.load(os.environ["STEP_STATE"])
cfg = smoke(ARCHS[state["arch"]])
params, batch = state["params"], state["batch"]
opt = init_opt_state(params)
step = make_train_step(cfg, AdamWCfg(lr=1e-3, warmup_steps=1,
                                     total_steps=10))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
with use_mesh(mesh):
    specs = param_specs(params, mesh)
    placed = distribute(params, specs, mesh)
    # every weight of this config is sharded, over data or model
    assert all(any(not p.is_replicate() for p in t.placements)
               for t in tree_leaves(placed) if t.ndim == 2)
    opt = {"m": distribute(opt["m"], specs, mesh),
           "v": distribute(opt["v"], specs, mesh), "step": opt["step"]}
    batch = distribute(batch, {k: Spec(("data",), None) for k in batch},
                       mesh)
    new, _, metrics = step(placed, opt, batch)
    full = tree_map(lambda t: t.full_tensor(), new)
    loss = metrics["loss"]
    loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss)
if RANK == 0:
    torch.save({"params": full, "loss": loss}, os.environ["STEP_OUT"])
dist.destroy_process_group()
"""


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's step from PRNGKey(0): (params before, batch,
    params after, loss)."""
    cfg = jax_smoke(JAX_ARCHS[arch])
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(tokens)}
    step = jax_make_train_step(cfg, JaxAdamWCfg(lr=1e-3, warmup_steps=1,
                                                total_steps=10))
    p_ref, _, m_ref = jax.jit(step)(params, jax_init_opt_state(params),
                                    batch)
    return (jax.tree.map(np.asarray, params), tokens,
            jax.tree.map(np.asarray, p_ref), float(m_ref["loss"]))


@pytest.mark.parametrize("arch", ARCHS_TESTED)
def test_sharded_step_matches_unsharded_steps_on_4_gloo_ranks(tmp_path,
                                                              arch):
    from repro_torch.optim.adamw import AdamWCfg, init_opt_state
    from repro_torch.train.step import make_train_step

    cfg = smoke(ARCHS[arch])
    before, tokens, after_ref, loss_ref = _reference(arch)
    params = params_from_jax(before, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(tokens)}
    state, out = tmp_path / "state.pt", tmp_path / "out.pt"
    torch.save({"arch": arch, "params": params, "batch": batch}, state)
    run_ranks(RANK_CODE, 4, timeout=400,
              env={"STEP_STATE": str(state), "STEP_OUT": str(out)})
    got = torch.load(out)

    step = make_train_step(cfg, AdamWCfg(lr=1e-3, warmup_steps=1,
                                         total_steps=10))
    p_port, _, m_port = step(params, init_opt_state(params), batch)
    np.testing.assert_allclose(got["loss"], float(m_port["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["loss"], loss_ref, rtol=LOSS_RTOL)
    want_ref = tree_leaves(params_from_jax(after_ref, cfg, device="cpu"))
    leaves = tree_leaves(got["params"])
    assert len(leaves) == len(tree_leaves(p_port)) == len(want_ref)
    for g, u, r in zip(leaves, tree_leaves(p_port), want_ref):
        np.testing.assert_allclose(g.numpy(), u.numpy(), **PARAM_TOL)
        np.testing.assert_allclose(g.numpy(), r.numpy(), **PARAM_TOL)


@pytest.mark.parametrize("fn", ["constrain", "whole", "split_dim",
                                "put_rows"])
def test_no_mesh_returns_the_input_itself(fn):
    assert ctx.active_mesh() is None
    assert ctx.active_policy() == "fsdp_tp"
    x = torch.randn(4, 6, 8)
    if fn == "constrain":
        assert ctx.constrain(x, "b", None, "m") is x
        assert ctx.constrain(x, "b", "m") is x
    elif fn == "whole":
        assert ctx.whole(x, -1) is x
    elif fn == "split_dim":
        y = ctx.split_dim(x, -1, 2)
        assert y.shape == (4, 6, 2, 4) and y.data_ptr() == x.data_ptr()
        assert torch.equal(y, x.reshape(4, 6, 2, 4))
    else:
        cache = torch.zeros(3, 5, 2)
        new = torch.randn(3, 2)
        slot = torch.tensor([0, 4, 2])
        keep = torch.tensor([False, True, False])[:, None]
        ctx.put_rows(cache, slot, keep, new)
        want = torch.zeros(3, 5, 2)
        want[0, 0], want[2, 2] = new[0], new[2]
        assert torch.equal(cache, want)


DEVICE_PROBE = """
import json
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.distributed.ctx import constrain, use_mesh
from repro_torch.distributed.sharding import Spec, distribute
from repro_torch.launch.mesh import init_fake_world, make_host_mesh

def error(fn):
    try:
        fn()
    except (RuntimeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return None

init_fake_world(1)
# a mesh on the card, built without one: the tensors below lie on the CPU
card = DeviceMesh("cuda", torch.arange(1).view(1, 1),
                  mesh_dim_names=("data", "model"), _init_backend=False)
w = {"w": torch.ones(4, 8)}
spec = {"w": Spec(None, "model")}

def constrain_on_card():
    with use_mesh(card):
        constrain(torch.ones(4, 8), "b", None)

meta = distribute({"w": torch.ones(4, 8, device="meta")}, spec, card)["w"]
print(json.dumps({
    "default": error(make_host_mesh),
    "cpu": make_host_mesh("cpu").device_type,
    "distribute": error(lambda: distribute(w, spec, card)),
    "constrain": error(constrain_on_card),
    "meta": [meta.device.type, str(meta.device_mesh.device_type)],
}))
"""


@pytest.fixture(scope="module")
def device_probe():
    import json
    import subprocess
    import sys

    from _torch_dist import ROOT

    r = subprocess.run(
        [sys.executable, "-c", DEVICE_PROBE], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["default", "cpu", "distribute",
                                  "constrain", "meta"])
def test_mesh_lies_on_the_card_unless_asked_and_never_moves_a_tensor(
        device_probe, case):
    """``make_host_mesh()`` resolves the card as every entry point does
    (so it raises without one), and a tensor whose device differs from
    the mesh's is refused, not copied there; a meta tensor lies
    anywhere."""
    got = device_probe[case]
    if case == "default":
        assert got.startswith("RuntimeError: no CUDA device"), got
    elif case == "cpu":
        assert got == "cpu"
    elif case in ("distribute", "constrain"):
        assert got == ("ValueError: a tensor on cpu cannot join a mesh on "
                       "'cuda'; move it first, or build the mesh on its "
                       "device"), got
    else:
        assert got == ["meta", "cuda"]
