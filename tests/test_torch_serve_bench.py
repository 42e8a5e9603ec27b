"""The measuring helpers of ``repro_torch.serve.bench`` that
``chip_smoke.py`` counts work and checks kernel calls with: the work
and bytes of attention calls at the shapes of the moe, encdec and vlm
paths (one query row, non-causal Sq < Skv, GQA groups), the relative L2
distance, and the per-signature record of checked calls."""
from __future__ import annotations

import types

import pytest
import torch

from repro_torch.serve import bench as sb


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset,pairs", [
    (1, 1536, False, None, 1535, 1536),          # decode cross attention
    (448, 1536, False, None, 1088, 448 * 1536),  # prefill cross attention
    (1536, 1536, False, None, 0, 1536 * 1536),   # whisper's encoder
    (2048, 2048, True, None, 0, 2048 * 2049 // 2),
    (5, 9, True, None, 4, sum(range(5, 10))),    # Sq < Skv, causal
    (6, 6, True, 2, 0, 1 + 2 * 5),               # a window of 2
])
def test_attention_pairs_count_the_unmasked_pairs(Sq, Skv, causal, window,
                                                  q_offset, pairs):
    assert sb.attention_pairs(Sq, Skv, causal=causal, window=window,
                              q_offset=q_offset, device="cpu") == pairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_work_counts_one_query_row_and_gqa(dtype):
    """4 D flops a pair and query head; q, k, v read and o written once,
    the KV heads counted as they are stored (group 8 reads 1/8 of q's
    heads' worth of K and V)."""
    B, H, KVH, D, Skv = 4, 64, 8, 128, 300
    q = torch.zeros((B, 1, H, D), dtype=dtype)
    k = v = torch.zeros((B, Skv, KVH, D), dtype=dtype)
    flops, nbytes = sb.attention_work(q, k, v, causal=False, window=None,
                                      q_offset=Skv - 1)
    size = torch.finfo(dtype).bits // 8
    assert flops == 4 * D * Skv * B * H
    assert nbytes == size * (2 * B * H * D + 2 * B * Skv * KVH * D)


def test_decode_work_counts_the_valid_cache():
    B, H, KVH, D, S = 3, 24, 8, 64, 100
    q = torch.zeros((B, H, D), dtype=torch.bfloat16)
    kc = vc = torch.zeros((B, S, KVH, D), dtype=torch.bfloat16)
    lengths = torch.tensor([1, 31, 100], dtype=torch.int32)
    flops, nbytes = sb.decode_work(q, kc, vc, lengths, window=None)
    assert flops == 4 * D * 132 * H
    assert nbytes == 2 * 132 * KVH * D * 2 + 2 * B * H * D * 2 + 3 * 4
    flops, _ = sb.decode_work(q, kc, vc, lengths, window=20)
    assert flops == 4 * D * (1 + 20 + 20) * H


def test_rel_l2_of_a_zero_reference_is_the_absolute_distance():
    want = torch.zeros(4, 5)
    assert sb.rel_l2(want, want) == 0.0
    got = torch.full((4, 5), 0.5)
    assert sb.rel_l2(got, want) == pytest.approx(float(got.norm()))
    assert sb.rel_l2(got, torch.ones(4, 5)) == pytest.approx(0.5)


def test_checked_groups_calls_by_signature():
    """Every call is checked against the plain version; only the first
    call of each signature keeps its arguments, and each record carries
    its signature."""
    real = lambda x, *, scale: x * scale  # noqa: E731
    module = types.SimpleNamespace(fn=real)
    closes = []

    def close(got, want):
        closes.append(float((got - want).abs().max()))
        return (closes[-1], 0.0)

    a, b = torch.ones(2, 3), torch.ones(4, 3)
    with sb.checked(module, "fn", lambda x, *, scale: x * scale,
                    close) as calls:
        for x, scale in ((a, 2.0), (a, 2.0), (b, 2.0), (a, 3.0), (b, 2.0)):
            module.fn(x, scale=scale)
    assert closes == [0.0] * 5
    sigs = [c[3] for c in calls]
    assert len(set(sigs)) == 3
    assert sigs[0] == sigs[1] == ((((2, 3), "torch.float32"),),
                                  (("scale", 2.0),))
    kept = [c[1] is not None for c in calls]
    assert kept == [True, False, True, True, False]
    assert calls[2][1][0] is b and calls[3][2] == {"scale": 3.0}
    assert module.fn is real  # restored
