"""Maps and leaves of the port's parameter trees: dicts and lists of
tensors (None an empty subtree, as in the reference's trees)."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the tensors of trees of one structure, in the first
    tree's order; None stays None."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *parts) for parts in zip(*trees)]
    return None if first is None else fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in its order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]
