"""Reputation implementations (paper §IV-D1, §VI-E/F) — pluggable.

The paper's design: reputation only decreases, starts at 1.0, floors at 0.
Each FedAvg round the sender(s) of the lowest-accuracy model in the buffer
lose ``penalty`` (ties: all punished). Two concrete implementations are
evaluated in the paper:

    impl1 — penalty 0.01, FedAvg buffer 5   (fails under 1/5 malicious, Fig 14/15)
    impl2 — penalty 0.05, FedAvg buffer 10  (recovers, Fig 16/17)

Reputation is strictly local: node A's opinion of C is independent of B's
(§III-C). ``update_row`` operates on a reputation *row* (my scores for all
senders); the heap simulator keeps one dict per node.
"""
from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ReputationImpl:
    name: str
    penalty: float
    buffer_size: int
    initial: float = 1.0
    floor: float = 0.0

    def update_row(self, rep_row, sender_ids, accuracies):
        """Punish the lowest-accuracy sender(s) in this round's buffer.

        rep_row: (N,) my reputation for every known node id.
        sender_ids: (K,) integer ids of this buffer's model senders.
        accuracies: (K,) measured accuracy of each received model (my data).
        Returns the updated (N,) row. An empty buffer (K == 0) is a no-op:
        nobody is punished, the row passes through unchanged.
        """
        rep_row = torch.as_tensor(rep_row)
        accuracies = torch.as_tensor(accuracies, device=rep_row.device)
        if accuracies.shape[0] == 0:
            return rep_row
        worst = accuracies.min()
        punished = (accuracies <= worst + _EPS).to(rep_row.dtype)  # (K,)
        ids = torch.as_tensor(sender_ids, device=rep_row.device).long()
        # scatter-add penalties onto the row (a sender may appear once)
        delta = torch.zeros_like(rep_row).index_add_(
            0, ids, punished * self.penalty)
        return torch.clamp(rep_row - delta, self.floor, self.initial)


_REGISTRY: dict[str, ReputationImpl] = {}


def register(impl: ReputationImpl) -> ReputationImpl:
    _REGISTRY[impl.name] = impl
    return impl


def get(name: str) -> ReputationImpl:
    if name not in _REGISTRY:
        raise KeyError(f"unknown reputation impl {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# The paper's two evaluated implementations.
IMPL1 = register(ReputationImpl("impl1", penalty=0.01, buffer_size=5))
IMPL2 = register(ReputationImpl("impl2", penalty=0.05, buffer_size=10))
