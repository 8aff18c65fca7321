"""The training state as a tree, the port's stand-in for
``jax.tree_util`` over ``TrainState``, ``ParamTree`` and plain
containers.

A node is a ``NamedTuple`` (its fields), a ``ParamTree`` (its weights and
children by sorted key), an ``nn.ModuleList`` or a list or tuple (by
index), or a dict (by sorted key, as ``jax.tree.leaves``); anything else
is a leaf (a DTensor too).  Leaves are named as ``jax.tree_util`` names
key paths (``.params``, ``['embed']``, ``[3]``, joined by ``/``).
"""
from __future__ import annotations

import torch


def _is_state(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """``[(key path entry, child)]`` of a node, or None for a leaf."""
    from repro_torch.models.layers import ParamTree

    if _is_state(tree):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, ParamTree):
        kids = {**tree._parameters, **tree._modules}
        return [(f"['{key}']", kids[key]) for key in sorted(kids)]
    if isinstance(tree, dict):
        return [(f"['{key}']", tree[key]) for key in sorted(tree)]
    if isinstance(tree, (list, tuple, torch.nn.ModuleList)):
        return [(f"[{i}]", child) for i, child in enumerate(tree)]
    return None


def named_leaves(tree, prefix=()) -> list:
    """``[(name, leaf)]`` in the tree's order."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [item for key, child in kids
            for item in named_leaves(child, prefix + (key,))]


def path_str(name: str) -> str:
    """A leaf's name as ``'a/b/0/c'`` (the JAX package's ``_path_str``),
    the keys of a placements dict (``launch.tasks``)."""
    return "/".join(part.strip(".[]'") for part in name.split("/"))


def leaves(tree) -> list:
    """The leaves of ``tree`` in its order."""
    return [leaf for _, leaf in named_leaves(tree)]


def unflatten(like, values):
    """A tree of ``like``'s structure holding ``values`` (in ``like``'s
    leaf order); a ``ParamTree`` comes back as a new one of its class,
    its weights with no gradient."""
    from repro_torch.models.layers import ParamTree

    it = iter(values)

    def build(node, wrap=True):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, ParamTree):
            # Children as dicts and lists: the constructor makes them.
            raw = {**node._parameters, **node._modules}
            new = {key: build(raw[key], False) for key in sorted(raw)}
            out = {key: new[key] for key in raw}
            return type(node)(out) if wrap else out
        new = [build(child, wrap) for _, child in kids]
        if _is_state(node):
            return type(node)(*new)
        if isinstance(node, dict):
            by_key = dict(zip(sorted(node), new))
            return {key: by_key[key] for key in node}
        return new if isinstance(node, torch.nn.ModuleList) else type(node)(
            new)

    return build(like)
