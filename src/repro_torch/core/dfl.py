"""DFL federation of language models: the federation config, the
receipt (eval) function and one node's state (the JAX package's
``repro.core.dfl``).

In the JAX package a federation is one program over a device mesh whose
``fed`` axis holds the nodes, stacked. Here each node is a process (a rank
of the federation's process group, ``launch.mesh.spawn``) that holds its
whole replica, so ``init_federation`` builds one rank's node and nothing is
stacked on a rank.

The dry-run cell's helpers (``fed_axis_for``, ``gossip_rules``,
``abstract_fed_params``, ``abstract_gossip_round``: the JAX module's
``lower_gossip_round``) describe the federation over an abstract mesh
(``launch.mesh.AbstractMesh``) and trace one device's gossip round on the
meta device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch import sharding as sh
from repro_torch import tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import gossip as gossip_lib
from repro_torch.core import reputation as rep_lib
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
    a field: tokens and labels, or for the audio frontend frame embeddings
    (F, b, s, d_model), labels and a loss mask; the vision frontend adds
    patch embeddings (F, b, num_patch_tokens, d_model)."""
    b, s = dfl.val_rows, dfl.val_seq
    shape = (fed_size, b, s)
    if cfg.frontend == "audio":
        return {"frame_embeds": ((*shape, cfg.d_model), torch.bfloat16),
                "labels": (shape, torch.int32), "loss_mask": (shape, torch.float32)}
    out = {"tokens": (shape, torch.int32), "labels": (shape, torch.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = ((fed_size, b, cfg.num_patch_tokens, cfg.d_model),
                               torch.bfloat16)
    return out


def fed_axis_for(mesh) -> str:
    return "pod" if "pod" in mesh.axis_names else (
        "fed" if "fed" in mesh.axis_names else "data")


def gossip_rules(cfg: ArchConfig, fed_axis: str) -> dict:
    """Sharding rules inside the gossip round: never the fed axis for the
    model's dims, no FSDP when the data axis is the fed axis."""
    rules = sh.make_rules(fsdp=cfg.fsdp and fed_axis != "data")
    rules[sh.BATCH] = () if fed_axis == "data" else (("data",),)
    rules[sh.FED] = ((fed_axis,),)
    return rules


def _prepend_fed(axes_tree):
    return tree.map(lambda a: (sh.FED, *a), axes_tree, is_leaf=sh.is_axes)


def abstract_fed_params(cfg: ArchConfig, fed_size: int):
    """(the federation's stacked params (F, ...) on the meta device, their
    logical axes with FED in front)."""
    params, axes = step_lib.abstract_params(cfg)
    fed = tree.map(lambda p: torch.empty((fed_size, *p.shape), dtype=p.dtype,
                                         device=p.device), params)
    return fed, _prepend_fed(axes)


def val_batch_axes(val_batch):
    """Logical axes of a (F, b, ...) validation batch of tensors."""
    return {k: (sh.FED, sh.BATCH, *([None] * (v.dim() - 2)))
            for k, v in val_batch.items()}


def abstract_gossip_round(cfg: ArchConfig, shape: InputShape, mesh, dfl: DFLConfig,
                          val_rows: int):
    """(round_fn, args): one device's gossip round over ``mesh`` and its
    inputs on the meta device, for the JAX module's ``lower_gossip_round``.
    ``round_fn(*args)`` runs node 0's round: it receives the schedule's
    payloads (meta tensors; each exchange reports its bytes with
    ``kernels.report_collective``), takes a receipt on each with its
    validation batch of ``val_rows`` rows and averages (Eq. 3); trace it
    under a ``launch.op_cost.OpCost``."""
    if shape.kind != "train":
        raise ValueError("the DFL gossip round applies to training shapes")
    fed_size = mesh.shape[fed_axis_for(mesh)]
    round_fn = gossip_lib.make_gossip_round(
        make_lm_eval_fn(cfg), fed_size=fed_size, ttl=dfl.ttl,
        rep_impl=rep_lib.get(dfl.reputation), compress=dfl.compress, mesh=mesh,
        topology=dfl.make_topology(fed_size), schedule=dfl.schedule)
    params, _ = step_lib.abstract_params(cfg)
    meta = step_lib.META
    val = {k: torch.empty((val_rows, *dims[2:]), dtype=dt, device=meta)
           for k, (dims, dt) in val_batch_specs(cfg, dfl, 1).items()}
    rep_row = torch.ones((fed_size,), dtype=torch.float32, device=meta)
    return round_fn, (params, rep_row, val)


def init_federation(cfg: ArchConfig, fed_size: int, generator, opt=None,
                    device="cuda"):
    """One node of the federation, this rank's: params drawn from its own
    ``generator`` (a ``torch.Generator`` on ``device``), its optimizer
    state and step counter, and its (F,) reputation row (its opinion of
    every node, all ones)."""
    dev = device_lib.resolve(device)
    state = step_lib.init_train_state(cfg, generator, opt, device=dev)
    return state, torch.ones((fed_size,), dtype=torch.float32, device=dev)
