"""The one traffic generator: a ring of distinct training batches from the
seed, drawn by a traffic file's parameters.

Tokens follow a Zipf unigram law over the vocabulary (exponent ``zipf``);
with probability ``copy_prob`` a token is instead a fixed permutation of its
predecessor, so the stream has structure a model can learn. Labels are the
next token, -1 at the end of each row. Batch ``i`` of the ring comes from
``SeedSequence([seed, i])``, so every batch differs and the same seed gives
the same ring. (The law is that of the program's ``data/pipeline.py``
``SyntheticLM``, copied here so that the program cannot change it.)
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def ring(traffic: dict, vocab: int, seed: int) -> List[Dict[str, np.ndarray]]:
    rows, seq, n = traffic["batch"], traffic["seq"], traffic["ring"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x7A1F]))
    perm = rng.permutation(vocab)
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** traffic["zipf"]
    p /= p.sum()
    cdf = np.cumsum(p)
    out = []
    for i in range(n):
        r = np.random.default_rng(np.random.SeedSequence([int(seed), i]))
        base = np.minimum(np.searchsorted(cdf, r.random((rows, seq)), side="right"), vocab - 1)
        toks = base.copy()
        copy = r.random((rows, seq)) < traffic["copy_prob"]
        toks[:, 1:] = np.where(copy[:, 1:], perm[toks[:, :-1]], toks[:, 1:])
        labels = np.concatenate([toks[:, 1:], np.full((rows, 1), -1, np.int64)], axis=1)
        out.append({"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)})
    return out
