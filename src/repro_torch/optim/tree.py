"""Nested dicts and lists of tensors ("trees"), walked in the JAX
package's leaf order: a dict's keys sorted, a list's or tuple's items in
order. ``jax.tree.leaves`` sorts dict keys, so sums over leaves (the
global gradient norm) and pairings of leaves (params with their moments)
follow the reference's order."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of ``rest``
    (same structure), in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_unflatten(skeleton, leaves):
    """A tree of ``skeleton``'s structure holding ``leaves``, given in
    ``tree_leaves``' order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            out = [build(item) for item in node]
            return tuple(out) if isinstance(node, tuple) else out
        return next(it)

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out
