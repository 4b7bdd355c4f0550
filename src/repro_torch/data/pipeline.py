"""Host data pipeline for LM training (numpy copy of the JAX package's
``repro.data.pipeline``: the same seed, step and node give the same bytes).

The global batch is generated deterministically from (seed, step), so every
restart resumes the exact stream (the checkpoint stores only the step
counter), and each federation node draws its own stream: no central data
server, matching DFL's no-single-point-of-failure design.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import SyntheticTokens


class TokenPipeline:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, fed_nodes: int = 1):
        self.gen = SyntheticTokens(vocab_size, seed=seed)
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.fed_nodes = fed_nodes

    def batch_at(self, step: int, node: int = 0):
        """Deterministic batch for (step, federation node)."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + node) % (2 ** 31 - 1))
        return self.gen.batch(rng, self.global_batch, self.seq_len)

    def fed_batches(self, step: int, local_steps: int = 1):
        """(F, H, B, S) token/label arrays for one DFL round."""
        toks, labs = [], []
        for f in range(self.fed_nodes):
            bt, bl = [], []
            for h in range(local_steps):
                b = self.batch_at(step * local_steps + h, node=f)
                bt.append(b["tokens"])
                bl.append(b["labels"])
            toks.append(np.stack(bt))
            labs.append(np.stack(bl))
        return {"tokens": np.stack(toks), "labels": np.stack(labs)}
