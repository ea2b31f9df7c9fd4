"""Param trees as the port keeps them: nested dicts, lists, tuples and
``NamedTuple``s of tensors (``models/transformer.py``'s layout).

The reference walks its trees with ``jax.tree``; the port keeps the same
leaf order so a checkpoint's ``leaf_i`` and a flattened gradient list mean
the same leaf in both: dict keys sorted, then list and tuple order, then a
``NamedTuple``'s fields.  ``None`` is an empty subtree, as in JAX; every
other object is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = "*"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(node, out: list):
    if node is None:
        return None
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_flatten(node[k], out) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_flatten(v, out) for v in node])
    out.append(node)
    return _LEAF


def flatten(tree) -> tuple[list, Any]:
    """(leaves in the reference's order, the structure to rebuild with)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def leaves(tree) -> list:
    return flatten(tree)[0]


def unflatten(treedef, leaves_: list):
    """The tree of ``treedef`` with ``leaves_`` in flatten order."""
    it = iter(leaves_)

    def build(d):
        if d is None:
            return None
        if d == _LEAF:
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        if kind is list:
            return built
        if issubclass(kind, tuple) and hasattr(kind, "_fields"):
            return kind(*built)
        return kind(built)
    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure) -> a tree of ``tree``'s
    structure."""
    flat, treedef = flatten(tree)
    others = [leaves(r) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
