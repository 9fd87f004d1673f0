"""Token data pipeline: deterministic synthetic corpus -> packed LM batches.

A copy of ``repro.training.data_pipeline`` (numpy only): for the same
``DataConfig`` both give the same arrays, bit for bit, so ``document`` keeps
the reference's loop, whose calls fix the random stream.

No real corpus is read: documents are sampled from a
Zipf-distributed unigram model with Markov structure (enough signal for a
~100M-param model to visibly learn in a few hundred steps, which is what the
end-to-end train example demonstrates). Sequences are packed to fixed length
with cross-document attention left in (llama-style packing)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: int = 1
    doc_len_mean: int = 512


class SyntheticCorpus:
    """Markov chain over a Zipf vocabulary — learnable structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # sparse transition structure: each token prefers a few successors
        self.n_succ = 8
        self.succ = rng.integers(0, V, size=(V, self.n_succ))
        self.succ_p = rng.dirichlet(np.ones(self.n_succ) * 0.5, size=V)
        base = 1.0 / np.power(np.arange(1, V + 1), cfg.zipf_a)
        self.base_p = base / base.sum()
        self.rng = rng

    def document(self) -> np.ndarray:
        n = max(8, int(self.rng.exponential(self.cfg.doc_len_mean)))
        out = np.empty(n, np.int32)
        tok = int(self.rng.choice(self.cfg.vocab_size, p=self.base_p))
        for i in range(n):
            out[i] = tok
            if self.rng.random() < 0.9:  # follow the chain
                j = int(self.rng.choice(self.n_succ, p=self.succ_p[tok]))
                tok = int(self.succ[tok, j])
            else:  # jump
                tok = int(self.rng.choice(self.cfg.vocab_size, p=self.base_p))
        return out


def packed_batches(cfg: DataConfig, num_batches: int) -> Iterator[dict]:
    """Yields {"tokens": (B,S) int32, "labels": (B,S) int32} LM batches."""
    corpus = SyntheticCorpus(cfg)
    need = cfg.batch_size * (cfg.seq_len + 1)
    buf = np.empty(0, np.int32)
    for _ in range(num_batches):
        while buf.size < need:
            buf = np.concatenate([buf, corpus.document()])
        chunk, buf = buf[:need], buf[need:]
        arr = chunk.reshape(cfg.batch_size, cfg.seq_len + 1)
        yield {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy()}
