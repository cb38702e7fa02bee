"""Data pipeline: deterministic, shardable, resumable (a copy of
``repro.data.pipeline``: the batches are bit-identical to the
reference's for the same seed, host and step).

Two sources:
  * ``SyntheticLMDataset`` — a seeded Zipfian n-gram language (structured
    enough that models measurably learn it; used by examples/tests and the
    Table-II accuracy benchmark),
  * ``TokenFileDataset`` — memory-mapped uint16/uint32 token files (the
    production path: shard by host, sequential reads).

Both yield packed (tokens, labels) with next-token labels and support
``state_dict``/``load_state_dict`` so the fault-tolerant loop can resume
mid-epoch.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.common import ArchConfig


class SyntheticLMDataset:
    """Zipfian bigram-chain language with a few long-range copy rules."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.step = 0
        rng = np.random.default_rng(seed)
        v = vocab
        # sparse bigram table: each token has ~8 plausible successors
        self._succ = rng.integers(0, v, size=(v, 8))
        self._zipf_p = 1.0 / np.arange(1, 9)
        self._zipf_p /= self._zipf_p.sum()

    def _gen(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n + 1, np.int64)
        out[0] = rng.integers(0, self.vocab)
        choices = rng.choice(8, size=n, p=self._zipf_p)
        noise = rng.random(n)
        for i in range(n):
            if noise[i] < 0.05:       # 5% random restarts
                out[i + 1] = rng.integers(0, self.vocab)
            else:
                out[i + 1] = self._succ[out[i], choices[i]]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        # independent stream per (host, step) -> deterministic resume
        rng = np.random.default_rng(
            (self.seed, self.host_id, self.step))
        toks = np.stack([self._gen(rng, self.seq_len)
                         for _ in range(self.batch)])
        self.step += 1
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict):
        self.step = st["step"]
        assert st["seed"] == self.seed, "dataset seed changed across restart"


class TokenFileDataset:
    """Memory-mapped token file, host-sharded, sequential windows."""

    def __init__(self, path: str, seq_len: int, batch: int,
                 dtype=np.uint16, host_id: int = 0, n_hosts: int = 1):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.batch = batch
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.cursor = host_id * seq_len * batch

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        need = self.batch * (self.seq_len + 1)
        if self.cursor + need >= len(self.data):
            self.cursor = self.host_id * self.seq_len * self.batch
        flat = np.asarray(self.data[self.cursor:self.cursor + need])
        self.cursor += need * self.n_hosts
        toks = flat.reshape(self.batch, self.seq_len + 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state_dict(self):
        return {"cursor": self.cursor}

    def load_state_dict(self, st):
        self.cursor = st["cursor"]


def make_train_iterator(cfg: ArchConfig, seq_len: int, batch: int,
                        seed: int = 0, path: Optional[str] = None,
                        host_id: int = 0, n_hosts: int = 1):
    if path:
        return TokenFileDataset(path, seq_len, batch, host_id=host_id,
                                n_hosts=n_hosts)
    return SyntheticLMDataset(min(cfg.vocab, cfg.padded_vocab()), seq_len,
                              batch, seed, host_id, n_hosts)
