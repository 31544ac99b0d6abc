"""Deterministic synthetic LM data pipeline: host-sharded, resumable.

Counterpart of ``repro.data.synthetic``, a copy: it is numpy only, so
its batches are the reference's bit for bit.  The training loop moves
each batch to the model's device.

Every batch is a pure function of ``(seed, step, host_id)`` — no state to
checkpoint beyond the step counter, so restart/elastic-restore recovery
is "skip to step N" (see ``fault/``).  The generator models a crude
n-gram-ish structure (token t+1 depends on t) so tiny models can visibly
learn it in the examples/integration tests; labels mirror the tokens
(next-token prediction does the shift in the loss).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    structure: float = 0.8        # P(next token = f(current)) vs uniform


class SyntheticLM:
    """Stateless batch source; ``batch_at(step)`` is the whole API."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0, \
            "global batch must divide across hosts"
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.num_hosts
        # fixed random successor table: the "grammar" tiny models learn
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab_size,
                                  size=cfg.vocab_size).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 4096 + c.host_id)
        B, L = self.host_batch, c.seq_len
        toks = np.empty((B, L), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab_size, size=B)
        structured = rng.random((B, L - 1)) < c.structure
        noise = rng.integers(0, c.vocab_size, size=(B, L - 1))
        for i in range(1, L):
            toks[:, i] = np.where(structured[:, i - 1],
                                  self._succ[toks[:, i - 1]],
                                  noise[:, i - 1])
        return {"tokens": toks, "labels": toks.copy()}

    def iter_from(self, step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1
