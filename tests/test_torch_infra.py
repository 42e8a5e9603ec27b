"""The port's training infrastructure against the JAX package's and on
its own: synthetic data bit for bit with ``repro.data.pipeline``,
checkpoints (atomic commits, bf16 leaves, prune), exact resume of
``train_loop`` on the CPU, heartbeats and stragglers (mirroring
``tests/test_infra.py``)."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataCfg as JaxDataCfg
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.data.pipeline import pack_documents as jax_pack_documents
from repro_torch.ckpt.checkpoint import latest_step, prune, restore, save
from repro_torch.configs import ARCHS, smoke
from repro_torch.data.pipeline import DataCfg, SyntheticTokens, pack_documents
from repro_torch.ft.watchdog import (Heartbeat, StragglerDetector,
                                     check_heartbeats)
from repro_torch.launch import train as launch_train
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("step,n_hosts", [(0, 1), (3, 1), (7, 2), (5, 4)])
def test_batches_bit_identical_to_reference(step, n_hosts):
    kw = dict(vocab=1000, seq_len=32, global_batch=8, seed=99)
    for host in range(n_hosts):
        got = SyntheticTokens(DataCfg(**kw), host, n_hosts).batch(step)
        want = JaxSyntheticTokens(JaxDataCfg(**kw), host, n_hosts).batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        assert not np.shares_memory(got["tokens"], got["targets"])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["targets"][:, :-1])


def test_host_slices_cover_the_global_batch():
    cfg = DataCfg(vocab=1000, seq_len=16, global_batch=8)
    full = SyntheticTokens(cfg).batch(2)["tokens"]
    parts = [SyntheticTokens(cfg, h, 4).batch(2)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    it = iter(SyntheticTokens(cfg))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  SyntheticTokens(cfg).batch(0)["tokens"])
    with pytest.raises(ValueError, match="split"):
        SyntheticTokens(cfg, 0, 3)


def test_pack_documents_matches_reference():
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 50, n) for n in (5, 3, 9, 1, 12)]
    got = pack_documents(docs, seq_len=6, eos=99)
    np.testing.assert_array_equal(got, jax_pack_documents(docs, 6, 99))
    assert got.dtype == np.int32 and (got == 99).sum() >= 2


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn((4, 3), generator=gen),
            "blocks": [{"w": torch.randn((2, 2), generator=gen).to(
                torch.bfloat16)} for _ in range(3)],
            "b": {"c": torch.arange(5, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_round_trip_and_atomicity(tmp_path):
    tree = _tree()
    d = str(tmp_path)
    save(d, 7, tree)
    assert latest_step(d) == 7
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    names = {m["name"]: m["dtype"] for m in manifest["leaves"]}
    assert names["blocks__2__w"] == "bfloat16"
    assert names["b__c"] == "int32" and names["a"] == "float32"
    like = {"a": torch.zeros((4, 3)),
            "blocks": [{"w": torch.zeros((2, 2), dtype=torch.bfloat16)}
                       for _ in range(3)],
            "b": {"c": torch.zeros(5, dtype=torch.int32)},
            "step": torch.zeros((), dtype=torch.int32)}
    back = restore(d, 7, like)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    # a torn save (a tmp dir, a step dir without manifest) is invisible
    os.makedirs(tmp_path / ".tmp_step_9")
    os.makedirs(tmp_path / "step_9")
    assert latest_step(d) == 7
    save(d, 11, tree)
    save(d, 13, tree)
    prune(d, keep=1)
    assert latest_step(d) == 13
    assert sorted(os.listdir(d)) == [".tmp_step_9", "step_13"]
    with pytest.raises(KeyError, match="extra"):
        restore(d, 13, {**like, "extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="saved"):
        restore(d, 13, {**like, "a": torch.zeros((3, 4))})
    assert latest_step(str(tmp_path / "none")) is None


def test_train_resume_is_exact(tmp_path):
    """5 straight steps equal 3 steps, a crash and 2 resumed steps."""
    cfg = smoke(ARCHS["qwen3-0.6b"])
    kw = dict(steps=5, batch=4, seq=16, device="cpu")
    pa, opt_a, la = launch_train.train_loop(
        cfg, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **kw)
    launch_train.train_loop(cfg, ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
                            stop_after=3, **kw)
    assert latest_step(str(tmp_path / "b")) == 3
    pb, opt_b, lb = launch_train.train_loop(
        cfg, ckpt_dir=str(tmp_path / "b"), resume=True, ckpt_every=100, **kw)
    assert len(la) == 5 and len(lb) == 2
    np.testing.assert_allclose(lb, la[3:], rtol=1e-6)
    for a, b in zip(tree_leaves((pa, opt_a)), tree_leaves((pb, opt_b))):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-6, rtol=1e-6)
    assert int(opt_b["step"]) == 5
    assert la[-1] < la[0]


def test_train_cli_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final loss" in out and latest_step(str(tmp_path)) == 2
    assert (tmp_path / "heartbeat_0.json").exists()


def test_train_loop_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.train_loop(smoke(ARCHS["qwen3-0.6b"]), steps=1,
                                batch=2, seq=8, ckpt_dir=None)


def test_heartbeat_and_stragglers(tmp_path):
    hb0 = Heartbeat(str(tmp_path), 0)
    hb1 = Heartbeat(str(tmp_path), 1)
    hb0.beat(5)
    hb1.beat(5, {"loss": 1.5})
    assert check_heartbeats(str(tmp_path), timeout_s=1e6) == []
    assert check_heartbeats(str(tmp_path), timeout_s=-1.0) == [0, 1]
    rec = json.loads((tmp_path / "heartbeat_1.json").read_text())
    assert rec["step"] == 5 and rec["loss"] == 1.5
    (tmp_path / "heartbeat_2.json").write_text("{torn")
    assert check_heartbeats(str(tmp_path), timeout_s=1e6) == [2]

    det = StragglerDetector(k=3.0, patience=2)
    for _ in range(4):
        for h in range(4):
            det.record(h, 1.0 + (5.0 if h == 2 else 0.0))
        out = det.stragglers()
    assert out == [2]
    two = StragglerDetector()
    two.record(0, 1.0)
    two.record(1, 9.0)
    assert two.stragglers() == []
