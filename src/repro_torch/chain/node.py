"""A DFL node: the transaction/receipt/block/confirmation workflow of
Figs 1-4, plus the FedAvg buffer and local reputation table (§IV-D).

Port of the JAX package's ``repro.chain.node``. ML specifics are injected
as callbacks:

    train_fn(params, generator)      -> (params, train_metrics)
    eval_fn(params)                  -> accuracy on THIS node's data (receipts)
    params are dicts of tensors on the node's device; averaging uses
    repro_torch.core.fedavg (Eq. 2/3), or the wfedavg CUDA kernel's wrapper
    with use_kernel=True.

Adversaries are plug-ins (`repro_torch.chain.attacks`): pass ``attack=``
(name or instance) and the node broadcasts ``attack.apply(generator,
trained, committed, tick)`` instead of its honest model. The legacy
``malicious=True`` flag maps to the default ``gaussian`` attack.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.chain import attacks as attacks_lib
from repro_torch.chain import crypto
from repro_torch.chain.ledger import Ledger
from repro_torch.chain.types import (Block, BlockConfirmation, NodeInformation,
                                     Receipt, Transaction)
from repro_torch.core import fedavg
from repro_torch.core.reputation import ReputationImpl


@dataclasses.dataclass
class BufferedModel:
    sender: str
    params: object
    accuracy: float
    tx_digest: str


class DFLNode:
    def __init__(self, *, name: str, model_structure: str, params,
                 train_fn: Callable, eval_fn: Callable,
                 rep_impl: ReputationImpl, ttl: int = 2,
                 tx_per_block: int = 4, expire_after: float = 50.0,
                 malicious: bool = False, attack=None,
                 rng: Optional[torch.Generator] = None,
                 attack_key_fn: Optional[Callable] = None,
                 use_kernel: bool = False,
                 compress: Optional[str] = None):
        self.name = name
        self.kp = crypto.generate_keypair()
        self.info = NodeInformation.from_keypair(self.kp)
        self.ledger = Ledger(model_structure, self.info, self.kp)
        self.params = params
        self.train_fn = train_fn
        self.eval_fn = eval_fn
        self.rep_impl = rep_impl
        self.ttl = ttl
        self.tx_per_block = tx_per_block
        self.expire_after = expire_after
        if isinstance(attack, str):
            attack = attacks_lib.get(attack)
        if malicious and attack is None:
            attack = attacks_lib.get("gaussian")   # legacy §VI-E poisoning
        self.attack = attack
        self.malicious = attack is not None
        if rng is None:
            rng = torch.Generator(device=device_lib.of(params))
            rng.manual_seed(0)
        self.rng = rng
        # tick -> attack generator (FederationSpec.attack_key_fns); None
        # draws the attack from the node's own generator
        self.attack_key_fn = attack_key_fn
        self.last_broadcast = None      # most recent train_local output
        self.use_kernel = use_kernel
        if compress not in (None, "int8"):
            raise ValueError(f"unknown compress mode {compress!r}")
        self.compress = compress
        # ^ "int8": broadcasts ship int8-quantized (repro_torch.core.
        #   compression). The round-trip happens ONCE here at the sender;
        #   the heap Simulator hands every receiver the same params object.
        #   Committed self.params stay full precision; attacks apply BEFORE
        #   quantization.

        self.reputation: Dict[str, float] = {}   # address -> [0,1], local only
        self.buffer: List[BufferedModel] = []
        self.pending_tx: List[Transaction] = []  # receipts gathered, await block
        self.seen_tx: set[str] = set()
        # histories for the paper's figures
        self.accuracy_history: List[tuple] = []
        self.reputation_history: List[tuple] = []

    # ------------------------------------------------------------ local train
    def _to_wire(self, params):
        """Apply the configured wire compression to an outgoing broadcast
        (post-attack, pre-send — the quantized payload is what every
        receiver evaluates and buffers)."""
        if self.compress == "int8":
            from repro_torch.core import compression
            return compression.roundtrip_tree(params)
        return params

    def train_local(self, now: float):
        if self.attack is not None:
            # model poisoning: corrupt the honestly trained candidate at
            # broadcast time WITHOUT committing it (attackers' persistent
            # params never advance)
            trained, _ = self.train_fn(self.params, self.rng)
            gen = (self.attack_key_fn(now) if self.attack_key_fn is not None
                   else self.rng)
            out = self._to_wire(
                self.attack.apply(gen, trained, self.params, now))
            self.last_broadcast = out
            return out, {}
        self.params, metrics = self.train_fn(self.params, self.rng)
        self.last_broadcast = self._to_wire(self.params)
        return self.last_broadcast, metrics

    # ---------------------------------------------------- transactions (Fig 1)
    def create_transaction(self, model_params, now: float) -> Transaction:
        tx = Transaction(
            generator=self.info,
            create_time=now,
            expire_time=now + self.expire_after,
            ml_model=crypto.fingerprint_tree(model_params),
            ttl=self.ttl,
        ).seal(self.kp)
        self.seen_tx.add(tx.d)
        return tx

    def receive_transaction(self, tx: Transaction, model_params, now: float):
        """Verify, measure accuracy (the receipt), buffer the model, decide
        forwarding. Returns (receipt | None, forward: bool)."""
        if tx.d in self.seen_tx:
            return None, False              # duplicate (§IV-A2)
        self.seen_tx.add(tx.d)
        if not tx.verify(now=now):
            return None, False              # invalid/expired
        acc = float(self.eval_fn(model_params))
        receipt = Receipt(
            creator=self.info,
            transaction_digest=tx.d,
            received_at_ttl=tx.next_received_at_ttl(),  # Eq. (1)
            accuracy=acc,
            create_time=now,
        ).seal(self.kp)
        tx.receipts.append(receipt)
        sender = tx.generator.address
        self.reputation.setdefault(sender, self.rep_impl.initial)
        self.buffer.append(BufferedModel(sender, model_params, acc, tx.d))
        forward = receipt.received_at_ttl > 0
        return receipt, forward

    # -------------------------------------------------- weighted FedAvg (Eq 3)
    def maybe_update_model(self, now: float) -> bool:
        if len(self.buffer) < self.rep_impl.buffer_size:
            return False
        buf = self.buffer[: self.rep_impl.buffer_size]
        self.buffer = self.buffer[self.rep_impl.buffer_size:]
        dev = device_lib.of(self.params)
        reps = torch.tensor([self.reputation.get(b.sender, self.rep_impl.initial)
                             for b in buf], dtype=torch.float32, device=dev)
        accs = torch.tensor([b.accuracy for b in buf], dtype=torch.float32,
                            device=dev)
        weights = fedavg.model_weights(reps, accs)          # Eq. 2
        stacked = tree.map(lambda *xs: torch.stack(xs), *[b.params for b in buf])
        if self.use_kernel:
            from repro_torch.kernels.wfedavg import ops as wf_ops
            self.params = wf_ops.weighted_fedavg_tree(stacked, weights, self.params)
        else:
            self.params = fedavg.weighted_fedavg(stacked, weights, self.params)  # Eq. 3

        # reputation: punish the lowest-accuracy sender(s) (§IV-D1). The
        # accuracies are Python floats of fp32 values, so their min equals
        # the fp32 min without reading ``accs`` back from the device.
        worst = min(b.accuracy for b in buf)
        for b in buf:
            if b.accuracy <= worst + 1e-9:
                cur = self.reputation.get(b.sender, self.rep_impl.initial)
                self.reputation[b.sender] = max(
                    self.rep_impl.floor, cur - self.rep_impl.penalty)
        return True

    def attach_receipt(self, receipt: Receipt) -> bool:
        """Generator side of Fig 1: collect receipts flowing back for my own
        pending transactions (used later for block confirmations)."""
        if not receipt.verify():
            return False
        for tx in self.pending_tx:
            if tx.d == receipt.transaction_digest:
                if all(r.d != receipt.d for r in tx.receipts):
                    tx.receipts.append(receipt)
                return True
        return False

    # ---------------------------------------------------------- blocks (Fig 2)
    def stash_for_block(self, tx: Transaction):
        self.pending_tx.append(tx)

    def ready_for_block(self) -> bool:
        # the paper: gather transactions AND their receipts before drafting —
        # receiptless transactions cannot be witnessed (confirmed) yet
        return sum(1 for t in self.pending_tx if t.receipts) >= self.tx_per_block

    def draft_block(self, now: float) -> Block:
        with_receipts = [t for t in self.pending_tx if t.receipts]
        txs = with_receipts[: self.tx_per_block]
        chosen = {t.d for t in txs}
        self.pending_tx = [t for t in self.pending_tx if t.d not in chosen]
        return self.ledger.new_draft([t.copy() for t in txs], now)

    def confirm_block(self, draft: Block) -> List[BlockConfirmation]:
        """Neighbor side of Fig 2: confirm every receipt I created."""
        out = []
        for t in draft.transactions:
            for r in t.receipts:
                if r.creator.address == self.info.address and r.verify():
                    out.append(BlockConfirmation(
                        creator=self.info,
                        transaction_digest=t.d,
                        receipt_digest=r.d,
                        block_digest=draft.d,
                    ).seal(self.kp))
        return out

    def finalize_block(self, draft: Block,
                       confirmations: List[BlockConfirmation],
                       min_confirmations_per_tx: int = 1) -> bool:
        draft.confirmations = confirmations
        draft.finalize()
        return self.ledger.append(draft, min_confirmations_per_tx)

    # ---------------------------------------------------------------- metrics
    def record(self, now: float, test_accuracy: float):
        self.accuracy_history.append((now, test_accuracy))
        if self.reputation:
            self.reputation_history.append((now, dict(self.reputation)))
