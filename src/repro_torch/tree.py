"""Nested containers of tensors: the port's counterpart of ``jax.tree``.

Parameters, optimizer states and step states are nests of dicts, tuples,
lists and NamedTuples with tensors (or other values) at the leaves.
``leaves`` and ``named_leaves`` walk a nest in the JAX package's leaf
order: dict keys sorted at every level, sequences in order, ``None``
skipped, as ``jax.tree.leaves`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nests of one structure; the first nest's
    structure is kept. ``None`` stays ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        parts = [tree_map(fn, *p) for p in zip(*trees)]
        if hasattr(first, "_fields"):
            return type(first)(*parts)
        return type(first)(parts)
    return fn(*trees)


def unzip(tree, n: int) -> Tuple:
    """A nest of dicts whose leaves are n-tuples -> n nests of dicts."""
    if isinstance(tree, dict):
        parts = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: parts[k][i] for k in parts} for i in range(n))
    return tuple(tree)


def named_leaves(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in the JAX package's leaf order; a path is the tuple
    of keys and indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> Iterator:
    return (leaf for _, leaf in named_leaves(tree))


def get(tree, path: Tuple):
    for k in path:
        tree = tree[k]
    return tree


def from_paths(paths, values) -> dict:
    """The nest of dicts with ``values`` at ``paths`` (dict keys only)."""
    out: dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out
