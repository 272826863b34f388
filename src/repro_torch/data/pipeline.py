"""Synthetic, deterministic, shardable token pipeline.

The port's copy of ``repro.data.pipeline``: for equal seeds its batches
are bit-equal to the reference's (both draw from numpy's
``default_rng((seed, step))``); ``tests/test_torch_train_parity.py``
holds them so.

Generates a mixture of (a) Zipf-distributed "natural" tokens and (b) embedded
copy patterns so that a small model trained a few hundred steps measurably
reduces loss (the quickstart train example asserts this).  Batches are plain
numpy on host; the caller places them on device / across the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_fraction: float = 0.3   # fraction of positions covered by copy spans
    copy_span: int = 16


class TokenPipeline:
    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic per-step batch: {"tokens", "labels"}."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        zipf = rng.zipf(cfg.zipf_a, size=(b, s + 1))
        toks = (zipf % (cfg.vocab_size - 2)) + 2      # 0/1 reserved
        # overlay copy spans: x[t .. t+span] = x[t-span .. t]
        n_spans = int(cfg.copy_fraction * s / cfg.copy_span)
        for i in range(b):
            starts = rng.integers(cfg.copy_span, s - cfg.copy_span,
                                  size=n_spans)
            for t in starts:
                toks[i, t:t + cfg.copy_span] = toks[i, t - cfg.copy_span:t]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
