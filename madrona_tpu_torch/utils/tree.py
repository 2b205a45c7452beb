"""Walks over the port's state trees.

A tree is a tensor, or a dataclass (``SimState``, a ``Table``, the
``EntityStore``), dict, list or tuple of trees; any other value is a
leaf that is kept as it is. :func:`tree_map` rebuilds a tree with a
function applied to each tensor; :func:`tree_leaves` lists the tensors
with their paths, in the order :func:`tree_map` visits them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of ``tree``; other leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of ``tree``, the path built from
    ``prefix`` as ``prefix.field``, ``prefix.key`` and ``prefix[i]``."""
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = [(f".{k}", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return []
    return [leaf for key, child in items
            for leaf in tree_leaves(child, prefix + key)]
