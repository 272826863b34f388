"""Nested dicts of tensors read as JAX pytrees.

The port's params and train state are nested dicts, as the reference's
pytrees are.  ``jax.tree.flatten`` orders a dict's leaves by its sorted
keys, depth first (so ``blk10`` comes before ``blk2``, and in a train
state ``opt`` -- ``mu``, ``nu``, ``step`` -- before ``params``); the
optimizer, the train step and the checkpoint format walk leaves in that
order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List], Dict]]:
    """``leaves(tree)`` and a function that builds a tree of the same
    structure from a list of new leaves in that order."""
    def build(new: List):
        it = iter(new)

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(t[k]) for k in sorted(t)}
            return next(it)

        out = walk(tree)
        if next(it, None) is not None:
            raise ValueError("more leaves than the tree holds")
        return out

    return leaves(tree), build
