"""The port's LM kernels in float16: K2 (flash attention), K3 (flash
decode, q in float16 over bf16, float16 and float32 caches) and K4 (the
SSD scan, x in float16) against their plain versions, and the emulated
``mma.sync`` m16n8k16 f16 against numpy.

The sources are compiled as host C++ (``g++ -DHFAV_EMULATE``, with the
host ``__half`` of ``emulate.h``), as ``tests/test_torch_attn_kernels.py``
and ``tests/test_torch_ssd_kernel.py`` do for float32 and bf16; the
``cuda``-marked cases run the built kernels on the card.  The reference's
kernels upcast to float32 and write their outputs in the input's dtype,
as the port's do, so a float16 kernel and its plain version differ by
one float16 rounding of the output and float32 sums in another order:
the tolerance is ``chip_smoke.py``'s float16 ``ATTN_TOL`` and
``SSD_TOL`` (``atol=2.5e-4, rtol=4e-3``, relative L2 ``2.5e-4``: bf16's
divided by 4).  The module imports no JAX at its top level.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from _emulate import (EMU_ATTN_CASES, PRIMS_SRC, _attn_inputs, _frag, _np,
                      _torch, emulate_ssd, host_build, kernel_library,
                      ssd_inputs)
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_decode import kernel as k3
from repro_torch.kernels.ssd import kernel as k4
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import init_params
from repro_torch.serve import engine

FP16 = dict(atol=2.5e-4, rtol=4e-3)
FP16_REL_L2 = 2.5e-4


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _close(got, want, tag=""):
    """Within the float16 tolerance elementwise and in relative L2."""
    np.testing.assert_allclose(_np(got), _np(want), err_msg=tag, **FP16)
    assert _rel_l2(got, want) <= FP16_REL_L2, tag


@pytest.fixture(scope="module")
def emulated():
    """K2, K3 and K4 built by ``g++ -DHFAV_EMULATE``."""
    return {name: kernel_library(mod)
            for name, mod in (("fa", k2), ("fd", k3), ("ssd", k4))}


def test_emulated_f16_mma_matches_numpy():
    """``hfav_mma_f16`` (mma.sync m16n8k16 f16, float32 accumulation) and
    ldmatrix on float16 bits: the fragment layouts of the bf16 product,
    the values read as float16."""
    lib = host_build(PRIMS_SRC.replace("hfav_mma_bf16", "hfav_mma_f16"))
    rng = np.random.default_rng(12)
    mats = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(
        np.float32) * 100).half()
    mats[0, 0, 0, :4] = torch.tensor([65504.0, 1e-7, -6e-5, 0.5])  # range
    bits = mats.view(torch.int16).numpy().astype(np.uint16)
    vals = mats.float().numpy().astype(np.float64)
    raw = np.zeros((2, 32, 3, 4), np.uint32)
    d = np.zeros((2, 2, 16, 16), np.float32)
    shfl = np.zeros((2, 32, 5), np.float32)

    class Args(ctypes.Structure):
        _fields_ = [(n, ctypes.c_void_p) for n in ("m", "raw", "d", "shfl")]

    args = Args(bits.ctypes.data, raw.ctypes.data, d.ctypes.data,
                shfl.ctypes.data)
    assert lib.run_prims(ctypes.byref(args)) == 0
    halves = np.stack([raw & 0xffff, raw >> 16], axis=-1).astype(np.uint16)
    for w in range(2):
        A = bits[w, 0]
        for lane in range(32):
            np.testing.assert_array_equal(halves[w, lane, 0, 0],
                                          _frag(A[:8, :8], lane))
        a, bt, v = vals[w]
        np.testing.assert_allclose(d[w, 0], a @ bt.T, rtol=1e-6, atol=1e-2)
        np.testing.assert_allclose(d[w, 1], a @ v, rtol=1e-6, atol=1e-2)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", EMU_ATTN_CASES)
def test_emulated_flash_attention_float16_matches_plain(case, emulated):
    B, Sq, Skv, H, KVH, D, causal, window, q_off = case
    q, k, v = (_torch(a, "float16") for a in
               _attn_inputs((B, Sq, H, D), (B, Skv, KVH, D), 7))
    o = torch.full_like(q, float("nan"))
    blocks = k2.launch(emulated["fa"], q, k, v, o, causal=causal,
                       window=window, q_offset=q_off, scale=D ** -0.5,
                       stream=None)
    assert blocks == B * H * -(-Sq // 64)
    want = k2.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_off, scale=D ** -0.5)
    assert o.dtype == want.dtype == torch.float16
    _close(o, want, str(case))


# B, S, H, D; P split in two float16 terms against one: emulated, the
# relative L2 to the plain version was 1.3e-5 / 2.9e-8 with two terms
# (three: 1.2e-5 / 1.7e-8) and 2.4e-4 / 2.1e-4 with one
SPLIT_P_CASES = [(1, 257, 2, 128, 5e-5), (4, 32, 4, 16, 1e-6)]


@pytest.mark.parametrize("case", SPLIT_P_CASES)
def test_emulated_flash_attention_float16_split_p(case, emulated):
    """float16, causal: P split in two float16 terms keeps the float32
    function's accuracy (the output's own rounding aside); one float16 P
    is 10x further off and at the gate's relative L2."""
    B, S, H, D, bound = case
    q, k, v = (_torch(a, "float16") for a in
               _attn_inputs((B, S, H, D), (B, S, 1, D), 11))
    want = k2.flash_attention_plain(q, k, v, causal=True, window=None,
                                    q_offset=0, scale=D ** -0.5)
    one = kernel_library(k2, ("-DFA_F16_TERMS=1",))
    errs = []
    for lib in (emulated["fa"], one):
        o = torch.empty_like(q)
        k2.launch(lib, q, k, v, o, causal=True, window=None, q_offset=0,
                  scale=D ** -0.5, stream=None)
        errs.append(_rel_l2(o, want))
    assert errs[0] < bound
    assert errs[1] > 10 * errs[0] and errs[1] > 1e-4


def test_emulated_flash_attention_refuses_misaligned_float16(emulated):
    base = torch.zeros((1, 40, 2, 40), dtype=torch.float16)
    q = base[..., 1:33]
    k = v = torch.zeros((1, 40, 1, 32), dtype=torch.float16)
    with pytest.raises(ValueError, match="16 bytes"):
        k2.launch(emulated["fa"], q, k, v, torch.empty(q.shape,
                                                       dtype=q.dtype),
                  causal=True, window=None, q_offset=0, scale=0.2,
                  stream=None)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

# B, S, H, KVH, D, window, SM count, q dtype, cache dtype
EMU_DECODE_CASES = [
    (2, 90, 6, 2, 64, None, 32, "float16", "float16"),      # group 3
    (2, 90, 8, 1, 64, 40, 32, "float16", "bfloat16"),
    (2, 70, 8, 1, 128, None, 64, "float16", "float32"),     # group 8
    (3, 64, 4, 4, 80, 24, 16, "float16", "bfloat16"),
    (2, 90, 6, 2, 32, None, 256, "bfloat16", "float16"),
    (2, 70, 12, 1, 128, None, 64, "float32", "float16"),
]


def _decode(case, scale=(1.0, 1.0), seed=9):
    B, S, H, KVH, D, window, sms, qdt, cdt = case
    rng = np.random.default_rng(seed)
    q = _torch(rng.standard_normal((B, H, D)).astype(np.float32), qdt)
    kc, vc = (_torch((rng.standard_normal((B, S, KVH, D)) * s).astype(
        np.float32), cdt) for s in scale)
    lens = torch.from_numpy(rng.integers(1, S + 1, (B,)).astype(np.int32))
    lens[0] = 1
    return q, kc, vc, lens


def _k3(lib, case, q, kc, vc, lens):
    B, S, H, KVH, D, window, sms, _, _ = case
    bufs = k3.buffers(q, KVH, k3.n_splits(B, KVH, S, sms))
    k3.launch(lib, q, kc, vc, lens, *bufs, window=window, scale=D ** -0.5,
              stream=None)
    return bufs[0], k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                          scale=D ** -0.5)


@pytest.mark.parametrize("case", EMU_DECODE_CASES)
def test_emulated_flash_decode_float16_matches_plain(case, emulated):
    q, kc, vc, lens = _decode(case)
    got, want = _k3(emulated["fd"], case, q, kc, vc, lens)
    assert got.dtype == q.dtype
    if q.dtype == torch.float16:
        _close(got, want, str(case))
    else:  # one rounding of the output in q's dtype, or none
        tol = dict(atol=2e-2, rtol=2e-2) if q.dtype == torch.bfloat16 \
            else dict(atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_emulated_flash_decode_rounds_bf16_caches_through_float16(emulated):
    """Under float16 q a bf16 cache is rounded to float16 first, as the
    reference casts the caches to the compute dtype: keys below 2**-14
    become float16 subnormals (values below 2**-24 vanish), which reading
    the bf16 bits straight as float would not do; the kernel gives the
    plain version's bits, about 4e-3 from the direct reading."""
    case = (2, 90, 6, 2, 64, None, 32, "float16", "bfloat16")
    q, kc, vc, lens = _decode(case, scale=(8e-5, 3e-6))
    got, want = _k3(emulated["fd"], case, q, kc, vc, lens)
    direct = k3.flash_decode_plain(q.float(), kc.float(), vc.float(), lens,
                                   window=None, scale=64 ** -0.5).half()
    _close(got, want)
    assert _rel_l2(direct, want) > 1e-3


def test_emulated_flash_decode_bf16_cache_past_float16_range(emulated):
    """bf16 cached values past 65504 are Inf in float16, so their
    sequence's output is not finite in the kernel as in the plain
    version (and in the reference); the other sequences are unharmed."""
    case = (2, 40, 4, 2, 32, None, 32, "float16", "bfloat16")
    q, kc, vc, lens = _decode(case)
    lens = torch.tensor([30, 40], dtype=torch.int32)
    vc[0, 3, 0, 5] = 1e6
    got, want = _k3(emulated["fd"], case, q, kc, vc, lens)
    np.testing.assert_array_equal(np.isfinite(_np(got)),
                                  np.isfinite(_np(want)))
    assert not np.isfinite(_np(want[0])).all()
    _close(got[1], want[1])


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

# B, S, H, P, N, chunk
SSD_CASES = [
    (2, 128, 3, 32, 16, 32),    # 4 chunks, one tile each
    (1, 256, 2, 64, 64, 128),   # zamba2-2.7b's P and N
    (2, 256, 1, 64, 128, 256),  # mamba2-130m's: one chunk of 4 tiles
    (1, 200, 2, 20, 100, 256),  # L = 200: a partial tile
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_emulated_ssd_float16_matches_plain(case, emulated):
    B, S, H, P, N, chunk = case
    args = ssd_inputs(B, S, H, P, N, seed=1, dtype=torch.float16)
    got, L = emulate_ssd(emulated["ssd"], args, chunk)
    want = ssd_scan(*args, chunk=L)
    assert got.dtype == want.dtype == torch.float16
    _close(got, want, str(case))


@pytest.mark.parametrize("case", SSD_CASES[:2])
def test_emulated_ssd_float16_matches_reference_kernel(case, emulated):
    """Against the JAX package's ``ssd_pallas`` in interpret mode with x
    in float16 (JAX imported here only)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd import ssd_pallas

    B, S, H, P, N, chunk = case
    args = ssd_inputs(B, S, H, P, N, seed=1, dtype=torch.float16)
    got, _ = emulate_ssd(emulated["ssd"], args, chunk)
    j = [jnp.asarray(_np(a)) for a in args]
    j[0] = j[0].astype(jnp.float16)
    want = ssd_pallas(*j, chunk=chunk, interpret=True)
    assert want.dtype == jnp.float16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=2.5e-3, rtol=2.5e-3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMU_ATTN_CASES + [
    (2, 128, 128, 4, 2, 64, True, None, 0),
    (1, 257, 257, 2, 1, 128, True, None, 0)])
def test_flash_attention_float16_matches_plain_on_card(case):
    _need_card()
    B, Sq, Skv, H, KVH, D, causal, window, q_off = case
    q, k, v = (_torch(a, "float16", "cuda") for a in
               _attn_inputs((B, Sq, H, D), (B, Skv, KVH, D), 7))
    before = k2.launches
    got = k2.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_off)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    _close(got, k2.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_off,
                                         scale=D ** -0.5), str(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMU_DECODE_CASES)
def test_flash_decode_float16_matches_plain_on_card(case):
    _need_card()
    q, kc, vc, lens = (t.cuda() for t in _decode(case))
    before = k3.launches
    got = k3.flash_decode(q, kc, vc, lens, window=case[5])
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.flash_decode_plain(q, kc, vc, lens, window=case[5],
                                 scale=case[4] ** -0.5)
    if q.dtype == torch.float16:
        _close(got, want, str(case))
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES + [(4, 2048, 24, 64, 128, 256)])
def test_ssd_float16_matches_plain_on_card(case):
    _need_card()
    B, S, H, P, N, chunk = case
    args = ssd_inputs(B, S, H, P, N, seed=1, device="cuda", dtype=torch.float16)
    before = k4.launches
    got = k4.ssd_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    _close(got, ssd_scan(*args, chunk=k4.chunk_len(S, chunk)), str(case))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-130m"])
def test_float16_slices_on_card_kernels_match_plain_path(name):
    """Prefill and greedy decode of the float16 smoke configs with
    ``attn_impl="pallas"`` (K2 and K3, or K4) on the card against the
    same weights with ``attn_impl="chunked"``."""
    _need_card()
    cfg = smoke(ARCHS[name]).replace(attn_impl="pallas", dtype="float16")
    plain = cfg.replace(attn_impl="chunked")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)).cuda()
    counts = (k2.launches, k3.launches, k4.launches)
    got, _ = engine.make_prefill_step(cfg)(params, {"tokens": prompt})
    want, _ = engine.make_prefill_step(plain)(params, {"tokens": prompt})
    np.testing.assert_allclose(_np(got), _np(want), atol=2.5e-3, rtol=2.5e-3)
    toks = engine.greedy_decode(params, cfg, prompt[:, :12], 8, 64)
    assert toks.shape == (4, 8)
    after = (k2.launches, k3.launches, k4.launches)
    if name == "qwen3-0.6b":
        assert after[0] == counts[0] + cfg.n_layers
        assert after[1] == counts[1] + cfg.n_layers * (12 + 8 - 1)
    else:
        assert after[2] == counts[2] + cfg.n_layers
