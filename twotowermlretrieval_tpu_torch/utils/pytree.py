"""Nested-dict <-> flat-dict serialization for parameters.

The ``model.npz`` layout of the artifact directory, shared with the JAX
package: keys are '/'-joined paths, values are numpy arrays, and tuple
levels are keyed 0..n-1. Leaves may be numpy arrays or torch tensors; they
are written as numpy and read back as numpy (``models.two_tower.
params_from_jax`` turns a loaded tree into tensors).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # torch.Tensor, without importing torch here
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_params(tree: Any) -> Dict[str, np.ndarray]:
    """Depth-first flatten of nested dicts / tuples / lists. Dict keys are
    visited in sorted order, as ``jax.tree_util`` visits them."""
    flat: Dict[str, np.ndarray] = {}

    def visit(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], prefix + [str(k)])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                visit(v, prefix + [str(i)])
        else:
            flat["/".join(prefix)] = _to_numpy(node)

    visit(tree, [])
    return flat


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in :func:`flatten_params`'s order (sorted dict
    keys, tuple positions), paths '/'-joined as ``jax.tree_util`` names
    them; the leaves are returned as they are."""
    out: List[Tuple[str, Any]] = []

    def visit(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], prefix + [str(k)])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                visit(v, prefix + [str(i)])
        else:
            out.append(("/".join(prefix), node))

    visit(tree, [])
    return out


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten_params(flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild nested dicts/tuples. A level whose keys are exactly 0..n-1
    becomes a tuple; otherwise a dict."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def materialize(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            if sorted(int(k) for k in keys) == list(range(len(keys))):
                return tuple(materialize(node[str(i)]) for i in range(len(keys)))
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def save_params_npz(path: str | Path, tree: Any) -> None:
    np.savez(path, **flatten_params(tree))


def load_params_npz(path: str | Path) -> Any:
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})
