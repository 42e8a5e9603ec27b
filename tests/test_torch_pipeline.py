"""``repro_torch.distributed.pipeline.pipeline_apply`` on 4 gloo CPU
ranks (one stage each) against the sequential loop and against the
reference's ``pipeline_apply`` on 4 host devices, with the reference
test's block, sizes and tolerance (``tests/test_distributed.py``:
L = 8, D = 16, 12 rows, 6 microbatches, ``atol=1e-5``)."""
import json
import os
import subprocess
import sys

import numpy as np

from _torch_dist import ROOT, run_ranks

L, D, ROWS, N_MICRO = 8, 16, 12, 6

PORT = f"""
import json
import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.roofline.analysis import CollectiveLog
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
rng = np.random.default_rng(0)
params = {{"w": torch.tensor(rng.standard_normal(({L}, {D}, {D})) * 0.2,
                           dtype=torch.float32),
          "b": torch.tensor(rng.standard_normal(({L}, {D})) * 0.1,
                           dtype=torch.float32)}}
x = torch.tensor(rng.standard_normal(({ROWS}, {D})), dtype=torch.float32)
def block(bp, h):
    return torch.tanh(h @ bp["w"] + bp["b"])
with CollectiveLog() as log:
    out = pipeline_apply(block, params, x, mesh, "stage", n_micro={N_MICRO})
print(json.dumps({{"rank": RANK, "out": out.tolist(),
                  "records": log.records}}))
dist.destroy_process_group()
"""

REFERENCE = f"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
mesh = jax.make_mesh((4,), ("stage",))
rng = np.random.default_rng(0)
params = {{"w": jnp.asarray(rng.standard_normal(({L}, {D}, {D})) * 0.2,
                           jnp.float32),
          "b": jnp.asarray(rng.standard_normal(({L}, {D})) * 0.1,
                           jnp.float32)}}
x = jnp.asarray(rng.standard_normal(({ROWS}, {D})), jnp.float32)
def block(bp, h):
    return jnp.tanh(h @ bp["w"] + bp["b"])
out = pipeline_apply(block, params, x, mesh, "stage", n_micro={N_MICRO})
print(json.dumps(np.asarray(out).tolist()))
"""


def _sequential() -> np.ndarray:
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    h = rng.standard_normal((ROWS, D)).astype(np.float32)
    for layer in range(L):
        h = np.tanh(h @ w[layer] + b[layer])
    return h


def test_pipeline_matches_sequential_and_reference():
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in run_ranks(PORT, 4, timeout=240)]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", REFERENCE], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.asarray(json.loads(r.stdout.strip().splitlines()[-1]))
    seq = _sequential()
    np.testing.assert_allclose(ref, seq, atol=1e-5)
    for o in outs:
        got = np.asarray(o["out"], dtype=np.float32)
        np.testing.assert_allclose(got, seq, atol=1e-5)
        np.testing.assert_allclose(got, ref, atol=1e-5)
    # every stage but the last sends one activation (2 rows x D float32)
    # a tick; the last stage's outputs are replicated by one all-reduce
    ticks = N_MICRO + 4 - 1
    mb_bytes = ROWS // N_MICRO * D * 4
    for o in outs:
        sends = [r for r in o["records"] if r[0] == "collective-permute"]
        assert sends == ([["collective-permute", mb_bytes, 4]] * ticks
                         if o["rank"] < 3 else [])
        assert [r for r in o["records"] if r[0] == "all-reduce"] == \
            [["all-reduce", ROWS * D * 4, 4]]
