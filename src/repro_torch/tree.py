"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

Dict keys are visited in sorted order, as ``jax.tree`` does, so leaf lists
and fingerprints line up with the JAX package's for the same params.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None) -> List:
    """Leaves in ``jax.tree.leaves`` order (sorted dict keys)."""
    out: List = []
    _collect(tree, is_leaf, out)
    return out


def _collect(t, is_leaf, out: List) -> None:
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that would keep ``out`` (at LM size a
    # model's worth of grads) alive until the garbage collector runs
    if (is_leaf is not None and is_leaf(t)) or not _is_node(t):
        out.append(t)
    elif isinstance(t, dict):
        for k in sorted(t):
            _collect(t[k], is_leaf, out)
    else:
        for v in t:
            _collect(v, is_leaf, out)


def unflatten(like, new_leaves, is_leaf: Optional[Callable[[Any], bool]] = None):
    """A tree shaped like ``like`` whose leaves, in ``leaves`` order, are
    ``new_leaves``."""
    it = iter(new_leaves)
    out = map(lambda _: next(it), like, is_leaf=is_leaf)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest, is_leaf: Optional[Callable[[Any], bool]] = None):  # noqa: A001
    """``jax.tree.map``: apply ``fn`` leafwise over trees of one structure."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("tree.map: dict structures differ")
        return {k: map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    for r in rest:
        if not isinstance(r, (list, tuple)) or len(r) != len(tree):
            raise ValueError("tree.map: sequence structures differ")
    out = [map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, v in enumerate(tree)]
    return type(tree)(out)
