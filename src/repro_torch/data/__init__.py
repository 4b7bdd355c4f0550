"""Synthetic datasets and non-I.I.D. partitioning (numpy, bit-identical to
the JAX package's for the same seed)."""
