"""Pytree helpers for the training state: nested dicts of tensors and the
`optim.AdamWState` named tuple.  Leaves come in the reference's order
(`jax.tree.leaves`: dict keys sorted, tuple fields in order), and each has
the reference's checkpoint key: dict keys joined by ``/``, a named-tuple
field as ``.name`` (how a JAX tree path prints it), e.g. ``embed/w``,
``.step``, ``.m/layers/attn/w_q``."""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def flatten(tree: Tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key, leaf) pairs in the reference's order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += flatten(sub, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree: Tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(template: Tree, values: list) -> Tree:
    """A tree of `template`'s structure holding `values` in leaf order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of trees of one structure."""
    cols = [leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
