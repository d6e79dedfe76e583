"""Deterministic synthetic token pipeline, copied from
`repro/data/pipeline.py` (numpy, bit-exact).

`batch_at(step)` is a pure function of (seed, step), so a restart replays the
exact data order with no state files, and each host materializes only its
slice of the global batch.  Sequences are Zipf-distributed token ids with
Markov structure so losses are non-trivial (the model can learn).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class TokenPipeline:
    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.host_batch = cfg.global_batch // n_hosts
        # fixed Zipf unigram table + a shift-register mixing rule
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(p / p.sum())

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for `step` (this host's slice), numpy int32."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        u = rng.random((self.host_batch, cfg.seq_len))
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        # Markov-ish structure: every other token correlates with its left
        # neighbour, so next-token prediction has learnable signal
        toks[:, 1::2] = (toks[:, 0::2][:, : toks[:, 1::2].shape[1]]
                         * 31 + 7) % cfg.vocab_size
        return {"tokens": toks}
