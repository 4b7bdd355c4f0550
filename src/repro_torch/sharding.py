"""Logical-axis sharding rules (MaxText-style), resolved against a mesh.

Port of the JAX package's ``repro.sharding``. Params and caches carry
*logical* axis names (the ``models.layers`` vocabulary plus the activation
and cache names below; ``transformer.param_axes`` / ``cache_axes`` give the
trees); ``logical_to_spec`` maps them to mesh axes, dropping any assignment
that does not divide the dim (kv_heads=2 cannot shard over model=16 ->
replicated). A spec is a tuple with one entry a dim: a mesh-axis name, a
tuple of names (sharded over several axes at once) or None (replicated),
trailing Nones dropped, as a JAX ``PartitionSpec`` holds them.

A mesh is any object with ``axis_names`` and ``shape`` (a mapping from
axis name to size): ``launch.mesh``'s abstract meshes, or a test's stand-in.
The port places nothing with these specs; the dry-run cell report
(``launch.dryrun``) divides each leaf by its ``shard_factor`` to get a
device's bytes.

``activation_sharding`` / ``maybe_shard`` are kept for the same call sites
and do nothing: in the JAX package they install ``with_sharding_constraint``
hints for the compiler, and the eager port has no compiler to hint, so its
models never call them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

from repro_torch import tree
from repro_torch.models import layers as L

# Activation / cache logical axes.
BATCH = "batch"
SEQ = "seq"
RES_SEQ = "res_seq"  # residual-stream seq dim at unit boundaries only
KV_SEQ = "kv_seq"
FED = "fed"  # federation replica dim (DFL mode)

# logical axis -> tuple of candidate mesh axes (first that exists+divides wins;
# multi-axis entries shard over several mesh axes at once).
DEFAULT_RULES: dict[str, tuple] = {
    L.VOCAB: (("model",),),
    L.HEADS: (("model",),),
    L.KV_HEADS: (("model",),),
    L.FFN: (("model",),),
    L.EXPERTS: (("model",),),
    L.EMBED: (),                   # replicated unless fsdp
    L.HEAD_DIM: (),
    L.RNN: (("model",),),
    L.STACK: (),
    L.CONV: (),
    BATCH: (("pod", "data"), ("data",)),
    SEQ: (),
    RES_SEQ: (),
    KV_SEQ: (),
    FED: (("fed",),),
}

FSDP_RULES = dict(DEFAULT_RULES)
FSDP_RULES[L.EMBED] = (("data",),)  # ZeRO-3: shard d_model over data

LONG_DECODE_RULES_EXTRA = {KV_SEQ: (("data",),)}  # sequence-parallel KV


def make_rules(*, fsdp: bool = False, shard_kv_seq: bool = False,
               extra: Optional[dict] = None) -> dict:
    rules = dict(FSDP_RULES if fsdp else DEFAULT_RULES)
    if shard_kv_seq:
        rules.update(LONG_DECODE_RULES_EXTRA)
    if extra:
        rules.update(extra)
    return rules


def logical_to_spec(axes: Sequence[Optional[str]], mesh, rules: dict,
                    shape: Sequence[int]) -> tuple:
    """Resolve logical axis names to a spec tuple, checking divisibility.
    A mesh axis is used at most once a spec."""
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, axes):
        assigned = None
        if name is not None:
            for cand in rules.get(name, ()):
                mesh_axes = tuple(a for a in cand
                                  if a in mesh.axis_names and a not in used)
                if not mesh_axes:
                    continue
                size = math.prod(mesh.shape[a] for a in mesh_axes)
                if size and dim % size == 0 and dim >= size:
                    assigned = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
                    used.update(mesh_axes)
                    break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def is_axes(x) -> bool:
    """Whether ``x`` is one leaf's logical axes: a tuple of names / Nones."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_specs(axes_tree, mesh, rules, params_tree):
    """Spec tree matching ``params_tree`` (tensors, or anything with
    ``.shape``), from the logical-axes tree that mirrors it."""
    axes = tree.leaves(axes_tree, is_leaf=is_axes)
    leaves = tree.leaves(params_tree)
    if len(axes) != len(leaves):
        raise ValueError(f"axes tree has {len(axes)} leaves, the tree {len(leaves)}")
    return tree.unflatten(params_tree, [
        logical_to_spec(a, mesh, rules, tuple(x.shape)) for a, x in zip(axes, leaves)])


def shard_factor(spec: tuple, mesh) -> int:
    """How many ways a spec splits its tensor: the product of the sizes of
    the mesh axes it names."""
    n = 1
    for entry in spec:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh.shape[a]
    return n


# ------------------------------------------------------- activation constraints
@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """No-op: the JAX package installs compiler hints here."""
    del mesh, rules
    yield


@contextlib.contextmanager
def no_activation_sharding():
    """No-op counterpart of the JAX package's context of the same name."""
    yield


def maybe_shard(x, axes: Sequence[Optional[str]]):
    """Returns ``x``: there is no compiler to hint (see the module doc)."""
    del axes
    return x
