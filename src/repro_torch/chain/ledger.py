"""Per-node blockchain database: a proof of contribution, not a ledger
(paper §III-F). No global chain exists — partial consensus means each node
keeps its own digest-chained history of the blocks it generated, witnessed by
neighbor confirmations.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.chain import crypto
from repro_torch.chain.types import Block, NodeInformation, Transaction, make_genesis


class Ledger:
    def __init__(self, model_structure: str, owner: NodeInformation,
                 kp: crypto.KeyPair):
        self.owner = owner
        self._kp = kp
        self.blocks: List[Block] = [make_genesis(model_structure, owner, kp)]

    @property
    def genesis_digest(self) -> str:
        return self.blocks[0].genesis_digest

    @property
    def head(self) -> Block:
        return self.blocks[-1]

    def new_draft(self, transactions: List[Transaction], now: float) -> Block:
        b = Block(
            generator=self.owner,
            create_time=now,
            previous_final_digest=self.head.final_digest,
            genesis_digest=self.genesis_digest,
            height=len(self.blocks),
            transactions=list(transactions),
        )
        return b.seal_draft(self._kp)

    def append(self, block: Block, min_confirmations_per_tx: int = 1) -> bool:
        if block.previous_final_digest != self.head.final_digest:
            return False
        if block.genesis_digest != self.genesis_digest:
            return False
        if not block.verify(min_confirmations_per_tx):
            return False
        self.blocks.append(block)
        return True

    def verify_chain(self, min_confirmations_per_tx: int = 1) -> bool:
        """Full immutability audit: digests chain, every block verifies."""
        for i, b in enumerate(self.blocks[1:], start=1):
            prev = self.blocks[i - 1]
            if b.previous_final_digest != prev.final_digest:
                return False
            if b.genesis_digest != self.genesis_digest:
                return False
            if not b.verify(min_confirmations_per_tx):
                return False
        return True

    def contribution_count(self, address: Optional[str] = None) -> int:
        """Transactions recorded for an address (proof of contribution)."""
        addr = address or self.owner.address
        return sum(1 for b in self.blocks for t in b.transactions
                   if t.generator.address == addr)
