"""Nested dict/list trees of tensors (parameters, grads, optimizer slots):
the little of ``jax.tree`` the port needs.

``leaves`` and ``map_tree`` walk dicts in their own key order and lists in
order, so ``leaves(t)`` lists the leaves in the order ``map_tree`` visits
them. ``map_tensors`` and ``tensors`` walk dicts, lists and tuples in the
same order and act on the tensors only (the eager API's trees: ``grad``'s
arguments, ``amp``'s casts, a loaded checkpoint).

The two pairs stay apart because they disagree on tuples: to
``leaves``/``map_tree`` a tuple is a leaf (the optimizer zips each param
with its grad and slots into a tuple leaf and lists them with ``leaves``),
while the eager API's trees hold tuples as containers and non-tensor leaves
that pass through untouched. On a tree of dicts and lists of tensors (a
params tree, an optimizer state) both give the same leaves in the same
order: ``tensors(t) == leaves(t)``.
"""

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["leaves", "map_tree", "map_tensors", "tensors"]


def leaves(tree):
    """The leaves of a nested dict/list tree, in visiting order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_tree(fn, tree, *rest, path=""):
    """``fn(path, leaf, *the matching nodes of rest)`` over ``tree``,
    keeping its structure. Each tree in ``rest`` must have ``tree``'s
    structure down to ``tree``'s leaves (where it may hold anything), or
    :class:`EnforceNotMet` names the first place it differs. ``path`` is
    dotted, e.g. ``layers.0.qkv_w``."""
    where = path or "the root"
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                got = sorted(r) if isinstance(r, dict) else type(r).__name__
                raise EnforceNotMet(f"at {where}: expected a dict with keys "
                                    f"{sorted(tree)}, got {got}")
        return {k: map_tree(fn, v, *(r[k] for r in rest),
                            path=f"{path}.{k}".lstrip("."))
                for k, v in tree.items()}
    if isinstance(tree, list):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise EnforceNotMet(f"at {where}: expected a list of "
                                    f"{len(tree)}, got {type(r).__name__}")
        return [map_tree(fn, v, *(r[i] for r in rest),
                         path=f"{path}.{i}".lstrip("."))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def map_tensors(fn, tree):
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to each tensor;
    other leaves kept."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tensors(tree):
    """The tensors of ``tree``, in :func:`map_tensors`' order."""
    out = []
    map_tensors(out.append, tree)
    return out
