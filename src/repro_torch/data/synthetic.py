"""Synthetic datasets (numpy copies of the JAX package's ``SyntheticMnist``
and ``SyntheticTokens``, so the same seed gives the same bytes).

MNIST is not available offline, so the paper-reproduction experiments use a
*synthetic 10-class digit-like dataset*: each class is a fixed random 28x28
template; samples are the template plus Gaussian noise and a random +-2 pixel
shift. LM training streams use a mixture-of-ngrams token generator so
losses fall below uniform (learnable structure), again with no external
data.
"""
from __future__ import annotations

import numpy as np


class SyntheticMnist:
    def __init__(self, num_classes: int = 10, image_size: int = 28,
                 noise: float = 0.35, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.num_classes = num_classes
        self.image_size = image_size
        self.noise = noise
        # smooth class templates (low-frequency random fields)
        base = rng.randn(num_classes, image_size // 4, image_size // 4)
        self.templates = np.stack([
            np.kron(b, np.ones((4, 4))) for b in base]).astype(np.float32)
        self.templates = np.clip(self.templates, -2, 2) * 0.5 + 0.5

    def sample(self, rng: np.random.RandomState, labels: np.ndarray):
        n = len(labels)
        imgs = self.templates[labels].copy()
        # random +-2 px shift
        for i in range(n):
            dx, dy = rng.randint(-2, 3, size=2)
            imgs[i] = np.roll(np.roll(imgs[i], dx, axis=0), dy, axis=1)
        imgs += rng.randn(n, self.image_size, self.image_size).astype(np.float32) * self.noise
        return imgs[..., None], labels

    def batch(self, rng: np.random.RandomState, batch_size: int,
              class_probs=None):
        labels = rng.choice(self.num_classes, size=batch_size, p=class_probs)
        return self.sample(rng, labels)


class SyntheticTokens:
    """Mixture-of-bigram LM stream: next-token depends on previous token via
    a sparse random transition table — learnable, non-trivial."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 4):
        rng = np.random.RandomState(seed)
        self.vocab = vocab_size
        self.next_tokens = rng.randint(0, vocab_size, size=(vocab_size, branch))

    def batch(self, rng: np.random.RandomState, batch_size: int, seq_len: int):
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, size=batch_size)
        for t in range(seq_len):
            choice = rng.randint(0, self.next_tokens.shape[1], size=batch_size)
            toks[:, t + 1] = self.next_tokens[toks[:, t], choice]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
