"""Token batches for LM training: a frozen copy of the synthetic bigram
stream the program's launcher trains on (a random table of ``branch``
successors a token; each next token one of its predecessor's successors,
chosen uniformly), drawn from the seed for all rows at once."""
from __future__ import annotations

import numpy as np

from perfbench.seeds import derive


def bigram_rows(seed: int, vocab: int, rows: int, seq: int, branch: int = 4):
    """(rows, seq) tokens and their next-token labels, int32."""
    rng = np.random.Generator(np.random.PCG64(derive(seed, "tokens", vocab)))
    table = rng.integers(0, vocab, (vocab, branch))
    toks = np.empty((rows, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, rows)
    choice = rng.integers(0, branch, (rows, seq))
    for t in range(seq):
        toks[:, t + 1] = table[toks[:, t], choice[:, t]]
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
