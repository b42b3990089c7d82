"""Parameter trees: lists of per-layer mappings (dicts or ParameterDicts,
nested where a layer nests) whose leaves are tensors or arrays.

One walker serves the network, the updaters and the checkpoint format, so
all three see the leaves in the same key order and name them with the JAX
package's ``keystr`` spelling (``[i]`` for a list index, ``['k']`` for a
mapping key).
"""

from __future__ import annotations


def _is_leaf(node):
    return not isinstance(node, (list, tuple)) and not hasattr(node, "items")


def tree_leaves(tree):
    """The leaves of ``tree`` in order (list order, then key order)."""
    if _is_leaf(tree):
        yield tree
        return
    for v in (tree if isinstance(tree, (list, tuple)) else tree.values()):
        yield from tree_leaves(v)


def tree_map(fn, *trees):
    """``fn`` over the leaves of ``trees`` (one structure), as plain lists
    and dicts shaped as the first."""
    first = trees[0]
    if _is_leaf(first):
        return fn(*trees)
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(first))]
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in first.keys()}


def tree_like(template, leaves):
    """Plain lists and dicts shaped as ``template``, filled in order from
    the ``leaves`` iterator."""
    if _is_leaf(template):
        return next(leaves)
    if isinstance(template, (list, tuple)):
        return [tree_like(v, leaves) for v in template]
    return {k: tree_like(v, leaves) for k, v in template.items()}


def flatten_tree(tree, prefix=""):
    """``{keystr path: leaf}`` with ``prefix`` before every path."""
    if _is_leaf(tree):
        return {prefix: tree}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}[{k}]" if isinstance(k, int)
                                else f"{prefix}['{k}']"))
    return out


def drop_entries(tree, drop, keys):
    """``tree`` with the entries of the layers (or vertices) in ``drop``
    emptied to ``{}``, so their leaves drop out of ``tree_leaves``.
    ``tree`` is a per-layer list or a dict keyed by ``keys`` (parameters,
    gradients, an updater's per-layer state), a dict of such trees (an
    updater's ``{"m": ..., "v": ...}``), or leafless (``()``). The
    entries left are the original objects, not copies."""
    if not drop:
        return tree
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(keys):
            return tree
        return [{} if i in drop else t for i, t in enumerate(tree)]
    if hasattr(tree, "items"):
        if set(tree.keys()) == set(keys):
            return {k: {} if k in drop else v for k, v in tree.items()}
        return {k: drop_entries(v, drop, keys) for k, v in tree.items()}
    return tree
