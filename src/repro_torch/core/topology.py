"""Static gossip topologies for the DFL federation (paper §VI-D scale-out).

The part of the JAX package's ``repro.core.topology`` that the heap
simulator needs: the ``Topology`` graph object with its heap-side views,
validation, and the circulant / full generators, as host-side numpy.
Random graphs (``erdos``, ``smallworld``), delivery budgets and gossip
permutation schedules serve the vectorized engine and the gossip round,
and are ported with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

KINDS = ("ring", "kregular", "full")


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected, connected, self-loop-free gossip graph."""

    kind: str
    adj: np.ndarray  # (N, N) bool, symmetric, zero diagonal

    def __post_init__(self):
        validate_adjacency(self.adj)

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    def neighbors(self, i: int) -> List[int]:
        return [int(j) for j in np.flatnonzero(self.adj[i])]

    def as_name_dict(self, names: Sequence[str]) -> Dict[str, List[str]]:
        """Adjacency in the heap `Simulator`'s {name: [peer, ...]} form."""
        if len(names) != self.num_nodes:
            raise ValueError(
                f"{len(names)} names for {self.num_nodes} nodes")
        return {names[i]: [names[j] for j in self.neighbors(i)]
                for i in range(self.num_nodes)}


def validate_adjacency(adj: np.ndarray) -> None:
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if adj.dtype != np.bool_:
        raise ValueError("adjacency must be boolean")
    if adj.shape[0] < 2:
        raise ValueError("a gossip graph needs at least 2 nodes")
    if np.diagonal(adj).any():
        raise ValueError("self-loops are not allowed")
    if not (adj == adj.T).all():
        raise ValueError("adjacency must be symmetric (undirected gossip)")
    if (adj.sum(axis=1) == 0).any():
        raise ValueError("isolated node: every node needs >= 1 neighbor")


def ring(n: int) -> Topology:
    return kregular(n, 1)


def kregular(n: int, k: int = 1) -> Topology:
    """Circulant ring: node i adjacent to i±1..i±k (mod n)."""
    if k < 1 or (2 * k > n - 1 and not (n % 2 == 0 and k == n // 2)):
        raise ValueError(f"kregular needs 1 <= k <= (n-1)/2 (or k=n/2, even "
                         f"n); got n={n}, k={k}")
    adj = np.zeros((n, n), np.bool_)
    for d in range(1, k + 1):
        for i in range(n):
            adj[i, (i + d) % n] = adj[i, (i - d) % n] = True
    return Topology("kregular" if k > 1 else "ring", adj)


def full(n: int) -> Topology:
    adj = ~np.eye(n, dtype=np.bool_)
    return Topology("full", adj)


def make(kind: str, n: int, *, degree: int = 2) -> Topology:
    """Factory over the ported families: ``ring|kregular|full``."""
    if kind == "ring":
        return ring(n)
    if kind == "kregular":
        return kregular(n, degree)
    if kind == "full":
        return full(n)
    raise ValueError(f"unknown or not yet ported topology {kind!r}; "
                     f"choose from {KINDS}")
