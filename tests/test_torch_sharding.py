"""The port's sharding rules against the reference's, leaf by leaf, for
every architecture at full size, on both production meshes and under
all three policies.

The rules read only a mesh's axis names and sizes, so no device is
needed: the reference's run on ``jax.sharding.AbstractMesh`` over
``jax.eval_shape`` leaves, the port's on
``repro_torch.launch.mesh.AbstractMesh`` over meta-device leaves.  The
reference stacks each block's layers on a leading axis it never shards;
the port keeps a list of per-layer dictionaries, so a port leaf under
``blocks``/``enc_blocks`` is held against the reference's spec without
its leading ``None``.  jax prints a one-axis tuple entry as the axis
name, so entries are compared with one-element tuples unwrapped."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed import sharding as ref
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import abstract_production_mesh, production_shape
from repro_torch.models import init_caches, init_params
from repro_torch.tree import tree_leaves, tree_paths

POLICIES = ("fsdp_tp", "fsdp_only", "zero_dp")
MESHES = (False, True)  # multi_pod
SDS = jax.ShapeDtypeStruct


def _meshes(multi_pod: bool):
    return (JaxAbstractMesh(*production_shape(multi_pod)),
            abstract_production_mesh(multi_pod=multi_pod))


def _norm(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_by_path(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_by_path(specs, like) -> list:
    """``(path with list indices dropped, spec, stacked)`` per leaf of
    ``like``."""
    out = []
    for path in tree_paths(like):
        s = specs
        for k in path:
            s = s[k]
        keys = tuple(str(k) for k in path if not isinstance(k, int))
        out.append((keys, s, any(isinstance(k, int) for k in path)))
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return jax.eval_shape(functools.partial(jax_init_params,
                                            cfg=JAX_ARCHS[arch]),
                          SDS((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return init_params(torch.Generator(), ARCHS[arch], device="meta")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_reference(arch, multi_pod, policy):
    jmesh, pmesh = _meshes(multi_pod)
    want = _ref_by_path(ref.param_specs(_ref_params(arch), jmesh, policy))
    params = _port_params(arch)
    got = _port_by_path(sharding.param_specs(params, pmesh, policy), params)
    assert len(got) == len(tree_leaves(params))
    assert {k for k, _, _ in got} == set(want)
    for keys, spec, stacked in got:
        w = want[keys]
        if stacked:
            assert w[0] is None, keys
            w = w[1:]
        assert isinstance(spec, sharding.Spec)
        assert _norm(spec) == _norm(w), (keys, spec, w)


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_match_reference(arch, multi_pod):
    jmesh, pmesh = _meshes(multi_pod)
    B, S = 128, 1024
    jc = jax.eval_shape(functools.partial(
        jax_init_caches, JAX_ARCHS[arch], B, S, cache_dtype=jnp.bfloat16))
    want = _ref_by_path(ref.cache_specs(jmesh, JAX_ARCHS[arch], jc))
    caches = init_caches(ARCHS[arch], B, S, device="meta")
    got = _port_by_path(sharding.cache_specs(pmesh, ARCHS[arch], caches),
                        caches)
    assert {k for k, _, _ in got} == set(want)
    for keys, spec, _ in got:
        assert _norm(spec) == _norm(want[keys]), keys


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("multi_pod", MESHES)
def test_data_specs_match_reference(kind, multi_pod):
    jmesh, pmesh = _meshes(multi_pod)
    cfg = ARCHS["qwen3-0.6b"]
    want = ref.data_specs(jmesh, JAX_ARCHS["qwen3-0.6b"], kind)
    got = sharding.data_specs(pmesh, cfg, kind)
    assert {k: _norm(v) for k, v in got.items()} == \
        {k: _norm(v) for k, v in want.items()}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("multi_pod", MESHES)
def test_sanitize_spec_matches_reference(seed, multi_pod):
    """Random shapes (dims of 1 to 64, some dividing the axes, some not)
    and random specs over the mesh's axes."""
    jmesh, pmesh = _meshes(multi_pod)
    rng = np.random.default_rng(seed)
    names = jmesh.axis_names
    choices = [None, *names, *((a, b) for a in names for b in names
                              if names.index(a) < names.index(b))]
    for _ in range(50):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice([1, 2, 8, 16, 24, 32, 48, 64]))
                      for _ in range(nd))
        entries = [choices[int(rng.integers(len(choices)))]
                   for _ in range(nd)]
        want = ref.sanitize_spec(shape, PartitionSpec(*entries), jmesh)
        got = sharding.sanitize_spec(shape, sharding.Spec(*entries), pmesh)
        assert _norm(got) == _norm(want), (shape, entries)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("multi_pod", MESHES)
def test_batch_and_weight_axes_match_reference(multi_pod, policy):
    jmesh, pmesh = _meshes(multi_pod)
    assert sharding.batch_axes(pmesh, policy) == \
        ref.batch_axes(jmesh, policy)
    assert sharding.weight_axes(pmesh, policy) == \
        ref.weight_axes(jmesh, policy)
