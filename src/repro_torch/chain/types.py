"""DFL blockchain data formats — the UML graphs of Figs 5-9 (paper §IV-B).

Signature-protected fields follow Table II exactly: a transaction's digest
covers (generator, create_time, expire_time, ml_model, ttl) — NOT receipts,
so appending receipts never changes the transaction digest (§IV-B3). A
receipt's received_at_ttl implements Eq. (1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.chain import crypto


@dataclass(frozen=True)
class NodeInformation:
    """Fig 5. address = hash(public_key)."""
    address: str
    public_key: str

    @classmethod
    def from_keypair(cls, kp: crypto.KeyPair) -> "NodeInformation":
        return cls(address=kp.address, public_key=kp.public_key)


@dataclass
class Receipt:
    """Fig 7. Created by each receiver of a transaction: accuracy measured on
    the receiver's OWN dataset; received_at_ttl per Eq. (1)."""
    creator: NodeInformation
    transaction_digest: str
    received_at_ttl: int
    accuracy: float
    create_time: float
    d: str = ""
    sig: str = ""

    def compute_digest(self) -> str:
        return crypto.hash_fields(
            self.creator.address, self.transaction_digest,
            self.received_at_ttl, f"{self.accuracy:.6f}", self.create_time)

    def seal(self, kp: crypto.KeyPair) -> "Receipt":
        self.d = self.compute_digest()
        self.sig = crypto.sign(kp, self.d)
        return self

    def verify(self) -> bool:
        return (self.d == self.compute_digest()
                and crypto.verify(self.creator.public_key, self.d, self.sig))


@dataclass
class Transaction:
    """Fig 6. ml_model is the signed model fingerprint (+ out-of-band payload
    reference); ttl bounds the partial-consensus broadcast range."""
    generator: NodeInformation
    create_time: float
    expire_time: float
    ml_model: str
    ttl: int
    d: str = ""
    sig: str = ""
    receipts: List[Receipt] = field(default_factory=list)

    def compute_digest(self) -> str:
        return crypto.hash_fields(
            self.generator.address, self.create_time, self.expire_time,
            self.ml_model, self.ttl)

    def seal(self, kp: crypto.KeyPair) -> "Transaction":
        self.d = self.compute_digest()
        self.sig = crypto.sign(kp, self.d)
        return self

    def verify(self, now: Optional[float] = None) -> bool:
        if self.d != self.compute_digest():
            return False
        if not crypto.verify(self.generator.public_key, self.d, self.sig):
            return False
        if now is not None and now > self.expire_time:
            return False  # late transaction: outdated model (§IV-B2)
        return True

    def next_received_at_ttl(self) -> int:
        """Eq. (1): min(trans.ttl, min receipts.received_at_ttl) - 1."""
        vals = [r.received_at_ttl for r in self.receipts]
        return min([self.ttl] + vals) - 1

    def copy(self) -> "Transaction":
        """Wire copy: a forwarded transaction is a serialized snapshot —
        receivers must never mutate the sender's receipt list."""
        return dataclasses.replace(self, receipts=list(self.receipts))


@dataclass
class BlockConfirmation:
    """Fig 9. A neighbor co-signs (transaction, receipt, block) it authored
    a receipt for — after this the generator cannot alter history."""
    creator: NodeInformation
    transaction_digest: str
    receipt_digest: str
    block_digest: str
    d: str = ""
    sig: str = ""

    def compute_digest(self) -> str:
        return crypto.hash_fields(
            self.creator.address, self.transaction_digest,
            self.receipt_digest, self.block_digest)

    def seal(self, kp: crypto.KeyPair) -> "BlockConfirmation":
        self.d = self.compute_digest()
        self.sig = crypto.sign(kp, self.d)
        return self

    def verify(self) -> bool:
        return (self.d == self.compute_digest()
                and crypto.verify(self.creator.public_key, self.d, self.sig))


@dataclass
class Block:
    """Fig 8. Two-phase: draft digest d covers content; final_digest also
    covers the gathered confirmations and chains into the next block."""
    generator: NodeInformation
    create_time: float
    previous_final_digest: str
    genesis_digest: str
    height: int
    transactions: List[Transaction] = field(default_factory=list)
    d: str = ""
    sig: str = ""
    confirmations: List[BlockConfirmation] = field(default_factory=list)
    final_digest: str = ""

    def compute_digest(self) -> str:
        return crypto.hash_fields(
            self.generator.address, self.create_time,
            self.previous_final_digest, self.genesis_digest, self.height,
            [t.d for t in self.transactions],
            [[r.d for r in t.receipts] for t in self.transactions])

    def seal_draft(self, kp: crypto.KeyPair) -> "Block":
        self.d = self.compute_digest()
        self.sig = crypto.sign(kp, self.d)
        return self

    def finalize(self) -> "Block":
        self.final_digest = crypto.hash_fields(
            self.d, [c.d for c in self.confirmations])
        return self

    def verify(self, min_confirmations_per_tx: int = 1) -> bool:
        if self.d != self.compute_digest():
            return False
        if not crypto.verify(self.generator.public_key, self.d, self.sig):
            return False
        if self.final_digest != crypto.hash_fields(
                self.d, [c.d for c in self.confirmations]):
            return False
        for t in self.transactions:
            if t.d != t.compute_digest():
                return False
            if not crypto.verify(t.generator.public_key, t.d, t.sig):
                return False
            for r in t.receipts:
                if not r.verify() or r.transaction_digest != t.d:
                    return False
        receipt_digests = {r.d for t in self.transactions for r in t.receipts}
        conf_by_tx: dict[str, int] = {}
        for c in self.confirmations:
            if not c.verify() or c.block_digest != self.d:
                return False
            if c.receipt_digest not in receipt_digests:
                return False
            conf_by_tx[c.transaction_digest] = conf_by_tx.get(c.transaction_digest, 0) + 1
        for t in self.transactions:
            if t.receipts and conf_by_tx.get(t.d, 0) < min_confirmations_per_tx:
                return False
        return True


def make_genesis(model_structure: str, creator: NodeInformation,
                 kp: crypto.KeyPair) -> Block:
    """The genesis block records the ML network structure so every node
    trains the same model (§IV-B4)."""
    g = Block(generator=creator, create_time=0.0, previous_final_digest="0" * 64,
              genesis_digest="", height=0)
    g.genesis_digest = crypto.hash_fields("genesis", model_structure)
    g.seal_draft(kp)
    return g.finalize()
