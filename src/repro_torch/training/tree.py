"""Trees of tensors — nested dicts, tuples, lists and dataclasses — in the
JAX package's flattening order: a dict's keys sorted, a sequence in order,
a dataclass's fields in declaration order. Paths are ``jax.tree_util``'s
``keystr`` of the same leaf (``.params['groups'][0][0]['attn']['wq']``),
so the i-th leaf of a port tree and of the reference's tree are the same
parameter, and a checkpoint's ``leaf_<i>`` means the same in both
packages."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _children(node: Any):
    """(path piece, child) pairs of an inner node, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for piece, child in kids
            for item in leaves_with_paths(child, prefix + piece)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree shaped like ``like`` whose leaves are ``flat``, in order."""
    it = iter(flat)

    def build(node):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others)])
