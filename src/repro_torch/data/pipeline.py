"""Deterministic synthetic token pipeline with per-host sharding (the
port of ``repro.data.pipeline``; numpy only, so batches are bit-identical
to the reference's).

Each host materializes only its slice of the global batch
(``host_id``/``n_hosts``); tokens are generated counter-based (any step
can be regenerated after a restart, which is what makes
checkpoint-restart exact), and sequences are Zipf-ish distributed so moe
routing and the loss are non-degenerate.  ``pack_documents`` provides
standard sequence packing for variable-length corpora."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataCfg:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


class SyntheticTokens:
    """Stateless counter-based stream: ``batch(step)`` is a pure
    function, so restarts resume exactly; per-host slicing needs no
    coordination."""

    def __init__(self, cfg: DataCfg, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """``tokens`` and ``targets`` (local_batch, seq_len) int32, two
        distinct buffers; ``targets[:, t]`` is the token at ``t + 1``."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.host_id * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng(cfg.seed + base + r)
            # one extra draw per row, so targets are the next-token shift
            u = rng.random(cfg.seq_len + 1)
            rows.append(np.minimum((cfg.vocab * u ** 3).astype(np.int64),
                                   cfg.vocab - 1))
        seq = np.stack(rows).astype(np.int32)
        return {"tokens": seq[:, :-1].copy(), "targets": seq[:, 1:].copy()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def pack_documents(docs: list[np.ndarray], seq_len: int, eos: int
                   ) -> np.ndarray:
    """Greedy sequence packing: concatenate docs with EOS separators and
    split into fixed-length rows (the ragged tail is dropped)."""
    flat: list[int] = []
    for d in docs:
        flat.extend(int(t) for t in d)
        flat.append(eos)
    n = len(flat) // seq_len
    return np.asarray(flat[: n * seq_len], np.int32).reshape(n, seq_len)
