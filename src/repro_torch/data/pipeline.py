"""Deterministic synthetic token pipeline (copy of
``repro/data/pipeline.py``; numpy only, so batches are bit-equal).

Addressing is (seed, step, host_index, num_hosts). The stream is a
Zipf-ish unigram mix where, with probability 1/2, a token is a fixed
permutation of its predecessor, so the loss falls during training.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "host_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Markov-flavoured synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.perm = rng.permutation(v)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks**1.1
        self.unigram = p / p.sum()

    def batch_at(self, step: int, host: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
        """The (deterministic) host-local slice of the global batch at step."""
        cfg = self.cfg
        if cfg.global_batch % num_hosts:
            raise ValueError("global_batch must divide evenly over hosts")
        local = cfg.global_batch // num_hosts
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, host, num_hosts]))
        base = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len), p=self.unigram)
        toks = base.copy()
        use_prev = rng.random((local, cfg.seq_len)) < 0.5
        toks[:, 1:] = np.where(use_prev[:, 1:], self.perm[toks[:, :-1]], toks[:, 1:])
        labels = np.concatenate([toks[:, 1:], np.full((local, 1), -1, np.int64)], axis=1)
        return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}

    def iterate(self, start_step: int = 0, host: int = 0,
                num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, host, num_hosts)
            step += 1


def host_batch(stream: SyntheticLM, step: int, mesh=None) -> Dict[str, np.ndarray]:
    """Single-process convenience: the whole global batch on this host."""
    return stream.batch_at(step, host=0, num_hosts=1)
