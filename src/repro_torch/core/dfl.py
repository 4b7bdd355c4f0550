"""DFL federation of language models: the federation config, the
receipt (eval) function and one node's state (the JAX package's
``repro.core.dfl``).

In the JAX package a federation is one program over a device mesh whose
``fed`` axis holds the nodes, stacked. Here each node is a process (a rank
of the federation's process group, ``launch.mesh.spawn``) that holds its
whole replica, so ``init_federation`` builds one rank's node and nothing is
stacked on a rank. The XLA dry-run path of the JAX module (``fed_axis_for``,
``gossip_rules``, ``abstract_fed_params``, ``lower_gossip_round``) lowers
the round onto a mesh; it comes with ``sharding.py`` (ROADMAP.md queue 1,
'CLI and the rest').
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core import topology as topology_lib
from repro_torch.models import transformer
from repro_torch.train import step as step_lib


@dataclasses.dataclass(frozen=True)
class DFLConfig:
    ttl: int = 1
    local_steps: int = 4          # H: optimizer steps between gossip rounds
    reputation: str = "impl2"
    compress: Optional[str] = None  # None | "int8"
    val_rows: int = 4             # validation microbatch rows per node
    val_seq: int = 1024           # validation sequence length (LM receipts)
    # gossip graph over the federation (repro_torch.core.topology.make)
    topology: str = "ring"        # ring|kregular|erdos|smallworld|full
    topology_degree: int = 2      # kregular/smallworld neighbor offsets
    topology_p: float = 0.25      # erdos edge probability
    topology_beta: float = 0.2    # smallworld rewiring probability
    topology_seed: int = 0
    schedule: str = "frontier"    # gossip lowering: frontier|chain

    def make_topology(self, fed_size: int) -> topology_lib.Topology:
        return topology_lib.make(
            self.topology, fed_size, degree=self.topology_degree,
            p=self.topology_p, beta=self.topology_beta,
            seed=self.topology_seed)


def schedule_report(dfl: DFLConfig, fed_size: int, *, strict: bool = True,
                    topo: Optional[topology_lib.Topology] = None) -> dict:
    """Audit the gossip lowering this DFLConfig produces at ``fed_size``.

    Returns coverage / collective-count facts for logging. With ``strict``
    (the default), a schedule that under-covers the ttl-ball raises instead
    of letting the round silently run with partial delivery — only
    reachable via the ``schedule="chain"`` regression oracle on irregular
    graphs. ``topo`` skips rebuilding an already-constructed topology.
    """
    if topo is None:
        topo = dfl.make_topology(fed_size)
    audit = topology_lib.audit_schedule(topo, dfl.ttl, schedule=dfl.schedule)
    report = {
        "topology": dfl.topology, "ttl": dfl.ttl, "schedule": dfl.schedule,
        "fed_size": fed_size,
        "coverage": round(audit.coverage, 4),
        "missing_pairs": len(audit.missing),
        "duplicate_pairs": len(audit.duplicates),
        "wasted_steps": len(audit.wasted_steps),
        "num_collectives": audit.num_collectives,
    }
    if strict and audit.missing:
        raise RuntimeError(
            f"gossip schedule under-covers the ttl-ball: "
            f"{len(audit.missing)} of the in-ball (receiver, sender) pairs "
            f"are never delivered (coverage {audit.coverage:.2f}) for "
            f"topology={dfl.topology} ttl={dfl.ttl} "
            f"schedule={dfl.schedule!r} at fed_size={fed_size}. Use the "
            f"default schedule='frontier' for exact ttl-ball flooding; "
            f"schedule='chain' is only a regression oracle.")
    return report


def make_lm_eval_fn(cfg: ArchConfig):
    """Receipt accuracy: token-level top-1 of ``transformer.train_loss`` on
    the receiver's microbatch, without autograd (the flash kernel then
    writes no log-sum-exp)."""

    def eval_fn(params, val_batch):
        with torch.no_grad():
            _, metrics = transformer.train_loss(params, cfg, val_batch)
        return metrics["accuracy"]

    return eval_fn


def val_batch_specs(cfg: ArchConfig, dfl: DFLConfig, fed_size: int):
    """(shape, dtype) of the federation's validation microbatches, (F, b, s)
    a field (token models)."""
    transformer.check_supported(cfg)
    shape = (fed_size, dfl.val_rows, dfl.val_seq)
    return {"tokens": (shape, torch.int32), "labels": (shape, torch.int32)}


def init_federation(cfg: ArchConfig, fed_size: int, generator, opt=None,
                    device="cuda"):
    """One node of the federation, this rank's: params drawn from its own
    ``generator`` (a ``torch.Generator`` on ``device``), its optimizer
    state and step counter, and its (F,) reputation row (its opinion of
    every node, all ones)."""
    dev = device_lib.resolve(device)
    state = step_lib.init_train_state(cfg, generator, opt, device=dev)
    return state, torch.ones((fed_size,), dtype=torch.float32, device=dev)
