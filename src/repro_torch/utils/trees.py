"""Bookkeeping of parameter trees: dicts, lists and tuples of tensors
(``repro.utils.trees``' counterparts; ``meta`` tensors count too)."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, dicts in key
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if tree is not None else []


def tree_bytes(tree) -> int:
    """Total bytes of the tree's tensors."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))
