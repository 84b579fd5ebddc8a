"""The token stream of a training cell, as a frozen copy of the port's
pipeline rule (`data/pipeline.py`): step `t`'s shard `j` is drawn from
numpy's `SeedSequence([seed, t, j])`, `rows = global_batch / n_shards`
rows of `seq_len + 1` tokens each, and the tokens are the first
`seq_len`, the labels the last. The harness holds the batches that the
trainer consumed against these, and the reference trains on these."""
from __future__ import annotations

import numpy as np


def step_batch(seed: int, step: int, vocab: int, seq_len: int,
               global_batch: int, n_shards: int) -> dict:
    rows = global_batch // n_shards
    parts = [np.random.default_rng(np.random.SeedSequence([seed, step, j]))
             .integers(0, vocab, (rows, seq_len + 1), dtype=np.int32)
             for j in range(n_shards)]
    toks = np.concatenate(parts, axis=0)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
