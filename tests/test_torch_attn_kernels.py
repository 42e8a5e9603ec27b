"""The port's attention kernels (K2 flash attention, K3 flash decode)
against their plain versions, which ``tests/test_torch_attention.py``
holds against the JAX package.  This file imports no JAX, so its
``cuda``-marked cases run on the card's machine, which has none.

* The warp collectives of the host emulation (``emulate.h``:
  ``ldmatrix`` x4 plain and ``.trans``, ``mma.sync`` m16n8k16 bf16,
  ``__shfl_xor_sync``) against numpy's matmul and transpose, which pins
  their fragment layouts independently of the kernels.
* The CUDA sources compiled as host C++ (``g++ -DHFAV_EMULATE``: blocks
  in sequence, a block's threads as host threads meeting at a barrier,
  warps exchanging operands through slots, bf16 by a shim in
  ``emulate.h``) and held against the plain versions: the kernels'
  tiling, fragments, swizzles, masking, tile skipping, strides, split
  and combine logic on the CPU, every K2 shape through both its
  tensor-core (bf16) and its float32 route.
* ``cuda``-marked cases (they skip without a card): each kernel against
  its plain version on the card, and the LM slice and the moe, encdec
  and vlm families with the kernels against the plain path on the same
  weights.

Tolerances: emulated float32 ``1e-5`` (the same float32 arithmetic in
another order); on the card float32 ``1e-4``; bf16 ``2e-2`` (one bf16
rounding of the output, or of the cached values), and for K2's split P
a relative L2 of ``2e-4`` (a single bf16 P gives ~1.9e-3 there) and
``5e-6`` on short rows (a split into two terms fails it).
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from _emulate import (EMU_ATTN_CASES, PRIMS_SRC, _attn_inputs, _frag, _np,
                      _torch, host_build, kernel_library)
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_decode import kernel as k3
from repro_torch.models import decode_step, init_caches, init_params
from repro_torch.serve import engine

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
TOL = dict(atol=2e-4, rtol=1e-3)
B, S0, STEPS, MAX_SEQ = 4, 12, 8, 64  # the shape of examples/serve_lm.py


# ---------------------------------------------------------------------------
# The CUDA sources compiled as host C++
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated():
    """The two kernels' libraries built by ``g++ -DHFAV_EMULATE``."""
    return {"fa": kernel_library(k2), "fd": kernel_library(k3)}


def test_emulated_warp_collectives_match_numpy():
    """ldmatrix x4 (plain and .trans), mma.sync m16n8k16 bf16 and
    __shfl_xor_sync of ``emulate.h`` against numpy's transpose and matmul
    (the PTX ISA's fragment layouts)."""
    lib = host_build(PRIMS_SRC)
    rng = np.random.default_rng(12)
    mats = torch.from_numpy(rng.standard_normal((2, 3, 16, 16)).astype(
        np.float32)).to(torch.bfloat16)
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
        A, Bt, V = bits[w]
        for lane in range(32):
            for i in range(4):  # 8 x 8 matrix i: rows 8 (i % 2), cols 8 (i // 2)
                r0, c0 = 8 * (i % 2), 8 * (i // 2)
                np.testing.assert_array_equal(
                    halves[w, lane, 0, i], _frag(A[r0:r0 + 8, c0:c0 + 8],
                                                 lane))
                np.testing.assert_array_equal(
                    halves[w, lane, 2, i], _frag(V[r0:r0 + 8, c0:c0 + 8].T,
                                                 lane))
                # Bt: matrices (n tile i // 2, k half i % 2)
                n0, k0 = 8 * (i // 2), 8 * (i % 2)
                np.testing.assert_array_equal(
                    halves[w, lane, 1, i], _frag(Bt[n0:n0 + 8, k0:k0 + 8],
                                                 lane))
        a, bt, v = vals[w]
        np.testing.assert_allclose(d[w, 0], a @ bt.T, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(d[w, 1], a @ v, rtol=1e-6, atol=1e-5)
        x = np.arange(32) * 1.5 + w
        for k in range(5):
            np.testing.assert_array_equal(shfl[w, :, k], x[np.arange(32)
                                                           ^ (1 << k)])


TF32_SRC = r"""
#include "emulate.h"
struct Args {
  const float* a;  // (16, 8)
  const float* b;  // (8, 8)
  const float* v;  // (64,) values to round
  unsigned* rounded;  // (64,)
  float* d;        // (16, 8)
};
void prims(const Args p) {
  const unsigned lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const unsigned a[4] = {hfav_tf32(p.a[g * 8 + t]),
                         hfav_tf32(p.a[(g + 8) * 8 + t]),
                         hfav_tf32(p.a[g * 8 + t + 4]),
                         hfav_tf32(p.a[(g + 8) * 8 + t + 4])};
  const unsigned b[2] = {hfav_tf32(p.b[t * 8 + g]),
                         hfav_tf32(p.b[(t + 4) * 8 + g])};
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  hfav_mma_tf32(d, a, b, d);
  for (unsigned e = 0; e < 4; ++e)
    p.d[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = d[e];
  p.rounded[lane] = hfav_tf32(p.v[lane]);
  p.rounded[lane + 32] = hfav_tf32(p.v[lane + 32]);
}
extern "C" int run_prims(const Args* p) {
  return emulate_launch(prims, *p, 1, 32, 0);
}
"""


def _tf32(v):
    """float32 values rounded to TF32 (11 significant bits) to nearest,
    ties away from zero, by frexp and ldexp."""
    m, e = np.frexp(v.astype(np.float64))
    s = m * 2.0 ** 11
    r = np.sign(s) * np.floor(np.abs(s) + 0.5)
    return np.ldexp(r, e - 11).astype(np.float32)


def test_emulated_tf32_mma_matches_numpy():
    """``hfav_tf32`` (cvt.rna.tf32.f32) and mma.sync m16n8k8 tf32 of
    ``emulate.h``: rounding against numpy's, ties away from zero, and
    the fragment layout (A rows g, g + 8 at columns t, t + 4; B rows t,
    t + 4 of column g) against numpy's matmul of the rounded operands."""
    lib = host_build(TF32_SRC)
    rng = np.random.default_rng(13)
    a = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                     2.0 ** -11, 0.0, 3e38], np.float32)
    v = np.concatenate([ties, rng.standard_normal(58).astype(np.float32)
                        * 10.0 ** rng.integers(-6, 6, 58)]).astype(np.float32)
    rounded = np.zeros(64, np.uint32)
    d = np.zeros((16, 8), np.float32)

    class Args(ctypes.Structure):
        _fields_ = [(n, ctypes.c_void_p)
                    for n in ("a", "b", "v", "rounded", "d")]

    args = Args(a.ctypes.data, b.ctypes.data, v.ctypes.data,
                rounded.ctypes.data, d.ctypes.data)
    assert lib.run_prims(ctypes.byref(args)) == 0
    got = rounded.view(np.float32)
    np.testing.assert_array_equal(got, _tf32(v))
    assert (rounded & 0x1fff == 0).all()
    assert got[0] == 1 + 2.0 ** -10 and got[1] == -(1 + 2.0 ** -10)
    want = _tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
    np.testing.assert_allclose(d, want, rtol=1e-6, atol=1e-6)
    # one TF32 rounding of each operand is far from float32's product
    assert np.abs(a.astype(np.float64) @ b - want).max() > 1e-4


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", EMU_ATTN_CASES)
def test_emulated_flash_attention_matches_plain(case, dt, emulated):
    B, Sq, Skv, H, KVH, D, causal, window, q_off = case
    q, k, v = _attn_inputs((B, Sq, H, D), (B, Skv, KVH, D), 7)
    q, k, v = _torch(q, dt), _torch(k, dt), _torch(v, dt)
    o = torch.full_like(q, float("nan"))
    blocks = k2.launch(emulated["fa"], q, k, v, o, causal=causal,
                       window=window, q_offset=q_off, scale=D ** -0.5,
                       stream=None)
    assert blocks == B * H * -(-Sq // 64)  # 64 query rows to a block
    want = k2.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_off, scale=D ** -0.5)
    # f32: reordered sums only; bf16: the same f32 arithmetic, one rounding
    # of the output
    tol = dict(atol=1e-5, rtol=1e-5) if dt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(o), _np(want), **tol)


def test_emulated_flash_attention_strided_inputs(emulated):
    """q, k, v read in place through their strides: views of one packed
    (B, S, 3, H, D) tensor, as a fused projection would leave them."""
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(
        rng.standard_normal((1, 50, 3, 2, 32)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    o = torch.empty((1, 50, 2, 32))
    k2.launch(emulated["fa"], q, k, v, o, causal=True, window=None,
              q_offset=0, scale=0.2, stream=None)
    want = k2.flash_attention_plain(q, k, v, causal=True, window=None,
                                    q_offset=0, scale=0.2)
    np.testing.assert_allclose(_np(o), _np(want), atol=1e-5, rtol=1e-5)


# B, S, H, D, bound emulated, bound on the card (whose tensor cores sum
# in another order): the causal case where one bf16 P gives ~1.9e-3, and
# short rows (a single 32-key tile), where a split into two bf16 terms
# fails the bounds and three (P_hi, P_mid, P_lo) meet them
SPLIT_P_CASES = [(1, 257, 2, 128, 2e-4, 2e-4), (4, 32, 4, 16, 5e-6, 1e-5)]


@pytest.mark.parametrize("case", SPLIT_P_CASES)
def test_emulated_flash_attention_split_p(case, emulated):
    """bf16, causal: the tensor-core kernel with P split in bf16 terms
    stays within the bound (relative L2) of the float32 function; P
    rounded to bf16 once (as SDPA does) would not."""
    B, S, H, D, bound, _ = case
    q, k, v = (_torch(a, "bfloat16") for a in
               _attn_inputs((B, S, H, D), (B, S, 1, D), 11))
    o = torch.empty_like(q)
    k2.launch(emulated["fa"], q, k, v, o, causal=True, window=None,
              q_offset=0, scale=D ** -0.5, stream=None)
    want = k2.flash_attention_plain(q, k, v, causal=True, window=None,
                                    q_offset=0, scale=D ** -0.5).float()
    assert _rel_l2(o, want) < bound
    # the bound has teeth: one bf16 rounding of the normalised P
    s = torch.einsum("bqhd,bkd->bhqk", q.float() * D ** -0.5,
                     k[:, :, 0].float())
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -1e30)
    p1 = torch.softmax(s, -1).to(torch.bfloat16).float()
    single = torch.einsum("bhqk,bkd->bqhd", p1, v[:, :, 0].float())
    assert _rel_l2(single.to(torch.bfloat16), want) > 1e-3


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("what", ["base", "stride", "out"])
def test_emulated_flash_attention_refuses_misaligned_bf16(what, emulated):
    """The tensor-core kernel copies 16-byte rows: a bf16 view of q (or,
    for "out", an output view) whose base or row stride is not 16-byte
    aligned raises ValueError, not a fallback."""
    rng = np.random.default_rng(13)
    D = 32
    wide = _torch(rng.standard_normal((1, 40, 2, D + 8)).astype(np.float32),
                  "bfloat16")
    if what == "base":  # one element past an aligned row start
        q = wide[..., 1:D + 1]
    elif what == "stride":  # rows of D + 1 elements
        base = _torch(rng.standard_normal((1, 40, 2 * (D + 1))).astype(
            np.float32), "bfloat16")
        q = base.as_strided((1, 40, 2, D), (40 * 2 * (D + 1), 2 * (D + 1),
                                            D + 1, 1))
    else:
        q = wide[..., :D].contiguous()
    k = v = _torch(rng.standard_normal((1, 40, 1, D)).astype(np.float32),
                   "bfloat16")
    o = torch.empty(q.shape, dtype=q.dtype) if what != "out" else \
        torch.empty((1, 40, 2, D + 4), dtype=q.dtype)[..., :D]
    with pytest.raises(ValueError, match="16 bytes"):
        k2.launch(emulated["fa"], q, k, v, o, causal=True, window=None,
                  q_offset=0, scale=0.2, stream=None)
    if what == "out":  # K3 writes its output one element at a time
        return
    with pytest.raises(ValueError, match="16 bytes"):  # K3's caches too
        k3.launch(emulated["fd"], q[:, 0], q, q, torch.ones(1, dtype=torch.int32),
                  *k3.buffers(q[:, 0], 2, 1), window=None, scale=0.2,
                  stream=None)


def _expected_split(lens, S: int, window, nsplit: int):
    """Per sequence: the keys of its valid range, and the split blocks
    of one KV head that hold a key when the range is cut into nsplit
    pieces of a multiple of 64 keys."""
    out = []
    for n in lens:
        end, start = min(n, S), max(0, n - window) if window else 0
        valid = max(end - start, 0)
        per = -(-(-(-valid // nsplit)) // 64) * 64
        out.append((valid, -(-valid // per) if valid else 0))
    return out


def _decode_case(case, lens, seed=9):
    B, S, H, KVH, D, window, sms, qdt, cdt = case
    rng = np.random.default_rng(seed)
    q = _torch(rng.standard_normal((B, H, D)).astype(np.float32), qdt)
    kc = _torch(rng.standard_normal((B, S, KVH, D)).astype(np.float32), cdt)
    vc = _torch(rng.standard_normal((B, S, KVH, D)).astype(np.float32), cdt)
    if lens is None:
        lens = rng.integers(1, S + 1, (B,)).astype(np.int32)
        lens[0] = 1
    return q, kc, vc, torch.tensor(lens, dtype=torch.int32)


def _check_launch(res, case, lens):
    """The blocks launched, and the keys each split block held: the
    valid range of every (sequence, KV head), each key once, in as many
    working splits as the policy gives."""
    B, S, H, KVH, D, window, sms, _, _ = case
    nsplit = k3.n_splits(B, KVH, S, sms)
    assert (res.split_blocks, res.combine_blocks) == (B * KVH * nsplit, B * H)
    keys = res.keys.cpu().numpy()
    assert keys.shape == (B, KVH, nsplit)
    exp = _expected_split([int(n) for n in lens], S, window, nsplit)
    for b, (valid, working) in enumerate(exp):
        assert (keys[b].sum(-1) == valid).all()
        assert ((keys[b] > 0).sum(-1) == working).all()
    assert res.working == KVH * sum(w for _, w in exp)


# B, S, H, KVH, D, window, SM count the split policy sizes for, q dtype,
# cache dtype
EMU_DECODE_CASES = [
    (2, 100, 4, 2, 32, None, 32, "float32", "float32"),
    (3, 64, 4, 4, 16, 24, 16, "float32", "float32"),
    (2, 90, 6, 2, 80, None, 256, "bfloat16", "float32"),
    (2, 90, 8, 1, 64, 40, 32, "bfloat16", "bfloat16"),
    (2, 70, 12, 1, 128, None, 64, "float32", "bfloat16"),
    (2, 90, 6, 2, 64, None, 32, "bfloat16", "bfloat16"),    # group 3
    (2, 70, 8, 1, 128, None, 32, "bfloat16", "bfloat16"),   # group 8
]


@pytest.mark.parametrize("case", EMU_DECODE_CASES)
def test_emulated_flash_decode_matches_plain(case, emulated):
    B, S, H, KVH, D, window, sms, qdt, cdt = case
    q, kc, vc, lens = _decode_case(case, None)
    nsplit = k3.n_splits(B, KVH, S, sms)
    bufs = k3.buffers(q, KVH, nsplit)
    res = k3.launch(emulated["fd"], q, kc, vc, lens, *bufs, window=window,
                    scale=D ** -0.5, stream=None)
    _check_launch(res, case, lens)
    want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                 scale=D ** -0.5)
    tol = dict(atol=1e-5, rtol=1e-5) if qdt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(bufs[0]), _np(want), **tol)


# short lengths in a long cache (the main path's), a window, lengths past
# the cache, and ranges long enough for every split
EMU_SPLIT_CASES = [
    ((3, 512, 4, 2, 128, None, 132, "bfloat16", "bfloat16"), [1, 17, 31]),
    ((3, 512, 4, 2, 64, 100, 132, "float32", "float32"), [1, 17, 500]),
    ((2, 300, 8, 2, 80, 40, 132, "bfloat16", "float32"), [290, 320]),
    ((2, 700, 4, 2, 32, None, 2, "float32", "bfloat16"), [700, 650]),
]


@pytest.mark.parametrize("case,lens", EMU_SPLIT_CASES)
def test_emulated_flash_decode_split_follows_lengths(case, lens, emulated):
    """Each split block takes its share of its sequence's valid range,
    found on the device: at lengths 1, 17 and 31 of a 512-position cache
    only the first split of each (sequence, KV head) holds keys."""
    B, S, H, KVH, D, window, sms, qdt, cdt = case
    q, kc, vc, lens = _decode_case(case, lens)
    bufs = k3.buffers(q, KVH, k3.n_splits(B, KVH, S, sms))
    res = k3.launch(emulated["fd"], q, kc, vc, lens, *bufs, window=window,
                    scale=D ** -0.5, stream=None)
    _check_launch(res, case, lens)
    if S == 512 and window is None:
        assert res.working == B * KVH < res.split_blocks
    want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                 scale=D ** -0.5)
    tol = dict(atol=1e-5, rtol=1e-5) if qdt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(bufs[0]), _np(want), **tol)


def test_emulated_flash_decode_length_past_the_cache(emulated):
    """A length past the cache counts the whole cache, as in the
    reference (whose grid covers only the cache), and reads nothing past
    it: the cache here is a view, and the rows after it are NaN."""
    rng = np.random.default_rng(10)
    S, D = 70, 32
    q = torch.from_numpy(rng.standard_normal((2, 4, D)).astype(np.float32))
    full = torch.full((2, S + 64, 2, D), float("nan"))
    full[:, :S] = torch.from_numpy(
        rng.standard_normal((2, S, 2, D)).astype(np.float32))
    kc = vc = full[:, :S]
    lens = torch.tensor([S + 9, 40], dtype=torch.int32)
    for window in (None, 30):
        bufs = k3.buffers(q, 2, k3.n_splits(2, 2, S))
        k3.launch(emulated["fd"], q, kc, vc, lens, *bufs, window=window,
                  scale=D ** -0.5, stream=None)
        want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                     scale=D ** -0.5)
        np.testing.assert_allclose(_np(bufs[0]), _np(want), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", EMU_ATTN_CASES + [
    (2, 128, 128, 4, 2, 64, True, None, 0),
    (1, 257, 257, 2, 1, 128, True, None, 0)])
def test_flash_attention_kernel_matches_plain_on_card(case, dt):
    _need_card()
    B, Sq, Skv, H, KVH, D, causal, window, q_off = case
    q, k, v = _attn_inputs((B, Sq, H, D), (B, Skv, KVH, D), 7)
    q, k, v = (_torch(a, dt, "cuda") for a in (q, k, v))
    before = k2.launches
    got = k2.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_off)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = k2.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_off, scale=D ** -0.5)
    tol = dict(atol=1e-4, rtol=1e-4) if dt == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dt == "bfloat16":  # split P: the float32 function's accuracy
        assert _rel_l2(got, want) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_P_CASES)
def test_flash_attention_split_p_on_card(case):
    _need_card()
    B, S, H, D, _, bound = case
    q, k, v = (_torch(a, "bfloat16", "cuda") for a in
               _attn_inputs((B, S, H, D), (B, S, 1, D), 11))
    got = k2.flash_attention_fwd(q, k, v, causal=True)
    want = k2.flash_attention_plain(q, k, v, causal=True, window=None,
                                    q_offset=0, scale=D ** -0.5)
    assert _rel_l2(got, want) < bound


@pytest.mark.cuda
def test_flash_attention_refuses_misaligned_bf16_on_card():
    _need_card()
    base = torch.randn((1, 40, 2, 40), device="cuda").to(torch.bfloat16)
    q = base[..., 1:33]
    k = v = torch.randn((1, 40, 1, 32), device="cuda").to(torch.bfloat16)
    before = k2.launches
    with pytest.raises(ValueError, match="16 bytes"):
        k2.flash_attention_fwd(q, k, v, causal=True)
    assert k2.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case,lens", [
    *((c, None) for c in EMU_DECODE_CASES), *EMU_SPLIT_CASES])
def test_flash_decode_kernel_matches_plain_on_card(case, lens):
    _need_card()
    B, S, H, KVH, D, window, sms, qdt, cdt = case
    q, kc, vc, lens = (t.cuda() for t in _decode_case(case, lens))
    before = k3.launches
    got = k3.flash_decode(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                 scale=D ** -0.5)
    tol = dict(atol=1e-4, rtol=1e-4) if qdt == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # the case's own split count, as the emulated case runs it
    bufs = k3.buffers(q, KVH, k3.n_splits(B, KVH, S, sms))
    res = k3.launch(k3.library(kc.dtype), q, kc, vc, lens, *bufs,
                    window=window, scale=D ** -0.5,
                    stream=torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    _check_launch(res, case, lens.cpu())
    torch.testing.assert_close(bufs[0].float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_on_card_kernels_match_plain_path(dtype):
    """Prefill and greedy decode with ``attn_impl="pallas"`` (K2, K3) on
    the card against the same weights with ``attn_impl="reference"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    cfg = smoke(ARCHS["qwen3-0.6b"]).replace(attn_impl="pallas", dtype=dtype)
    ref_cfg = cfg.replace(attn_impl="reference")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32)).cuda()
    n2, n3 = k2.launches, k3.launches
    got, _ = engine.make_prefill_step(cfg)(params, {"tokens": prompt})
    assert k2.launches == n2 + cfg.n_layers
    want, _ = engine.make_prefill_step(ref_cfg)(params, {"tokens": prompt})
    tol = TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    seen, ref_seen = [], []
    toks = engine.greedy_decode(params, cfg, prompt, STEPS, MAX_SEQ,
                                on_logits=seen.append)
    assert k3.launches == n3 + cfg.n_layers * (S0 + STEPS - 1)
    ref_toks = engine.greedy_decode(params, ref_cfg, prompt, STEPS, MAX_SEQ,
                                    on_logits=ref_seen.append)
    if dtype == "float32":
        assert torch.equal(toks, ref_toks)
    # bf16 rounding may pick another token; the prompt steps share a path
    same = len(seen) if torch.equal(toks, ref_toks) else S0
    for g, w in zip(seen[:same], ref_seen[:same]):
        torch.testing.assert_close(g, w, **tol)


FAMILIES = ["mixtral-8x7b", "granite-moe-3b-a800m", "whisper-small",
            "qwen2-vl-72b"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_on_card_kernels_match_plain_path(name, dtype):
    """A family's smoke config on the card: prefill (K2 per attention:
    whisper's encoder, decoder and cross attention) and four decode steps
    (K3 per layer, and whisper's cross attention by K2 at one query row)
    against the plain path (``"chunked"``) on the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    cfg = smoke(ARCHS[name]).replace(attn_impl="pallas", dtype=dtype)
    plain = cfg.replace(attn_impl="chunked")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S0)).astype(np.int32)).cuda()}
    if cfg.encdec is not None:
        batch["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)).cuda()
    tol = TOL if dtype == "float32" else BF16_TOL
    encdec = cfg.family == "encdec"
    k2.launches = k3.launches = 0
    got, caches = engine.make_prefill_step(cfg)(params, batch)
    assert (k2.launches, k3.launches) == (
        cfg.n_layers * (3 if encdec else 1), 0)
    want, _ = engine.make_prefill_step(plain)(params, batch)
    torch.testing.assert_close(got, want, **tol)
    kernel = init_caches(cfg, B, MAX_SEQ)
    ref = init_caches(plain, B, MAX_SEQ)
    if encdec:  # the prefill's encoder K/V in the cross caches
        for c in (kernel, ref):
            c["cross_k"].copy_(caches[1][0])
            c["cross_v"].copy_(caches[1][1])
    lengths = torch.zeros((B,), dtype=torch.int32, device="cuda")
    k2.launches = k3.launches = 0
    for t in range(4):
        lengths = lengths + 1
        tok = batch["tokens"][:, t]
        g = decode_step(params, tok, kernel, lengths, cfg)
        w = decode_step(params, tok, ref, lengths, plain)
        torch.testing.assert_close(g, w, **tol)
    assert (k2.launches, k3.launches) == (
        4 * cfg.n_layers if encdec else 0, 4 * cfg.n_layers)


@pytest.mark.cuda
def test_card_routes_have_no_autograd_link_so_wrappers_refuse_grad():
    """The fault the guard repairs: the launch routes of K2, K3 and K4
    write outputs with no autograd link, so a loss through them dropped
    the inputs' gradients silently (the plain versions, which the CPU
    route runs, give them); every wrapper now raises under grad on the
    card as on the CPU."""
    _need_card()
    from repro_torch.kernels.ssd import kernel as k4

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 64, 2, 64), generator=gen, device="cuda",
                    requires_grad=True)
    kw = dict(causal=True, window=None, q_offset=0, scale=0.125)
    o, run = k2.prepare(q, q, q, **kw)
    run()
    assert not o.requires_grad
    (g,) = torch.autograd.grad(
        k2.flash_attention_plain(q, q, q, **kw).square().sum(), q)
    assert float(g.abs().max()) > 0
    lengths = torch.full((1,), 40, dtype=torch.int32, device="cuda")
    q1 = torch.randn((1, 2, 64), generator=gen, device="cuda",
                     requires_grad=True)
    cache = torch.randn((1, 64, 2, 64), generator=gen, device="cuda")
    o3, run3 = k3.prepare(q1, cache, cache, lengths, window=None,
                          scale=0.125)
    run3()
    assert not o3.requires_grad
    x = torch.randn((1, 64, 2, 64), generator=gen, device="cuda",
                    requires_grad=True)
    dt = torch.full((1, 64, 2), 0.1, device="cuda")
    bm = torch.randn((1, 64, 16), generator=gen, device="cuda")
    A, D = -torch.ones(2, device="cuda"), torch.ones(2, device="cuda")
    y, run4 = k4.prepare(x, dt, A, bm, bm, D, chunk=64)
    run4()
    assert not y.requires_grad
    for call in (lambda: k2.flash_attention_fwd(q, q, q, causal=True),
                 lambda: k3.flash_decode(q1, cache, cache, lengths),
                 lambda: k4.ssd_kernel(x, dt, A, bm, bm, D, chunk=64)):
        with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()
