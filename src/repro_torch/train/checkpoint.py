"""Digest-chained checkpointing (checkpoint/restart fault tolerance), the
JAX package's ``repro.train.checkpoint`` with its on-disk format:

    step_<step>/shard-0.npz  every array, keyed by its tree path
    step_<step>/manifest.json: step, arch, extra, per-array {shape, dtype,
                   sha256}, prev_digest (previous checkpoint's manifest
                   digest), digest (sha256 of the above)

Keys join dict keys and sequence indices with ``/``, as the JAX
``_flatten`` does, so a state that both packages hold gives the same keys,
shapes, dtypes and digests, and either package reads the other's chain.

The prev_digest chain makes checkpoint history a DFL proof-of-contribution:
``verify_chain`` audits that no checkpoint was tampered with or dropped —
the blockchain idea (paper §III-F) applied to training artifacts. On restart
``restore`` re-verifies every array hash before handing state back.

One process writes a checkpoint (the federation launcher gathers its
ranks' states to rank 0 first), as the JAX package's single-process
container does: ``shard-0``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

SHARD = "shard-0.npz"


def _paths(tree, prefix=()):
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path`` order:
    sorted dict keys, sequence indices; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _key(path) -> str:
    return "/".join(re.sub(r"[\[\]'\.]", "", str(p)) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16: checkpoint fp32 state")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(p): _to_numpy(leaf) for p, leaf in _paths(tree)}


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def save(ckpt_dir: str, state, step: int, *, arch: str = "",
         extra: Optional[dict] = None) -> str:
    """Write checkpoint for `step`; returns the manifest digest."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = _flatten(state)
    np.savez(os.path.join(path, SHARD), **flat)

    prev = latest_manifest(ckpt_dir, before=step)
    manifest = {
        "step": step,
        "arch": arch,
        "extra": extra or {},
        "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "sha256": _digest(v)} for k, v in flat.items()},
        "prev_digest": prev["digest"] if prev else "0" * 64,
    }
    blob = json.dumps(manifest, sort_keys=True).encode()
    manifest["digest"] = hashlib.sha256(blob).hexdigest()
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest["digest"]


def _manifests(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir)):
        mf = os.path.join(ckpt_dir, d, "manifest.json")
        if os.path.exists(mf):
            with open(mf) as f:
                out.append((d, json.load(f)))
    return out


def latest_manifest(ckpt_dir: str, before: Optional[int] = None):
    ms = [m for _, m in _manifests(ckpt_dir)
          if before is None or m["step"] < before]
    return max(ms, key=lambda m: m["step"]) if ms else None


def verify_chain(ckpt_dir: str) -> bool:
    """Audit the digest chain across all checkpoints (proof of contribution)."""
    prev = "0" * 64
    for _, m in sorted(_manifests(ckpt_dir), key=lambda x: x[1]["step"]):
        if m["prev_digest"] != prev:
            return False
        blob = dict(m)
        digest = blob.pop("digest")
        recomputed = hashlib.sha256(
            json.dumps(blob, sort_keys=True).encode()).hexdigest()
        if recomputed != digest:
            return False
        prev = digest
    return True


def restore(ckpt_dir: str, state_like, step: Optional[int] = None):
    """Load the latest (or given) checkpoint into the structure of
    ``state_like`` (each array on its leaf's device). Verifies every
    array's sha256. Returns (state, step)."""
    m = (latest_manifest(ckpt_dir) if step is None
         else next((mm for _, mm in _manifests(ckpt_dir) if mm["step"] == step),
                   None))
    if m is None:
        raise FileNotFoundError(f"no checkpoint {'' if step is None else step} "
                                f"under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{m['step']:08d}")
    with np.load(os.path.join(path, SHARD)) as data:
        arrays = {k: data[k] for k in data.files}
    for k, spec in m["arrays"].items():
        if _digest(arrays[k]) != spec["sha256"]:
            raise ValueError(f"checkpoint corruption detected in {k}")
    pairs = _paths(state_like)
    keys = [_key(p) for p, _ in pairs]
    if set(keys) != set(arrays):
        raise ValueError(f"state structure mismatch: {sorted(set(keys) ^ set(arrays))}")

    def leaf(like, arr):
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        return torch.from_numpy(np.array(arr)).to(dev)

    new = iter([leaf(like, arrays[k]) for (_, like), k in zip(pairs, keys)])
    return _rebuild(state_like, new), m["step"]


def _rebuild(t, new):
    """``t``'s structure with its leaves, in ``_paths`` order, from ``new``."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _rebuild(t[k], new) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, new) for v in t)
    return next(new)


def prune(ckpt_dir: str, keep: int = 3):
    ms = sorted(_manifests(ckpt_dir), key=lambda x: x[1]["step"])
    for d, _ in ms[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
