"""Deterministic, shardable synthetic token pipeline.

The port of ``src/repro/data/pipeline.py``, copied: pure NumPy, so
``global_batch`` and ``host_slice`` are the reference's bit for bit. The
training loop uploads the int32 arrays to its device.

Properties a 1000-node fleet needs:
  * deterministic: batch(step) is a pure function of (seed, step) — restart
    or elastic re-shard never replays/skips data;
  * shardable: each data-parallel rank materializes only its slice
    (``host_slice``), so no rank ever holds the global batch;
  * checkpointable: state is just the step counter (stored by the ckpt
    manager alongside the model).

The synthetic stream is a Zipf-ish mixture with enough structure (bigram
template cycling) for loss curves to be meaningfully decreasing, which the
examples and convergence tests rely on.
"""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 n_ranks: int = 1, rank: int = 0):
        if batch % n_ranks:
            raise ValueError("global batch must divide across ranks")
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.n_ranks = n_ranks
        self.rank = rank
        self._templates = self._make_templates()

    def _make_templates(self):
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        n_templates = 64
        length = 48
        probs = 1.0 / np.arange(1, self.vocab + 1) ** 1.1
        probs /= probs.sum()
        return rng.choice(self.vocab, size=(n_templates, length), p=probs)

    def global_batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        tpl_idx = rng.integers(0, len(self._templates), self.batch)
        for b in range(self.batch):
            tpl = self._templates[tpl_idx[b]]
            reps = int(np.ceil((self.seq + 1) / len(tpl)))
            row = np.tile(tpl, reps)[: self.seq + 1].copy()
            noise = rng.random(self.seq + 1) < 0.1
            row[noise] = rng.integers(0, self.vocab, noise.sum())
            toks[b] = row
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_slice(self, step: int) -> dict:
        """This rank's shard of the deterministic global batch."""
        full = self.global_batch(step)
        per = self.batch // self.n_ranks
        lo = self.rank * per
        return {k: v[lo: lo + per] for k, v in full.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.host_slice(step)
            step += 1
