"""Trees of tensors (nested dicts, tuples and lists, as the port's params
and train state are) and their accounting.

``tree_flatten`` orders leaves as ``jax.tree.flatten`` does: dict keys
sorted, tuples and lists in order, ``None`` an empty subtree.  So leaf
``i`` of a port tree and leaf ``i`` of the JAX package's tree of the
same layout are the same parameter, which is what lets a checkpoint
(leaves keyed by flatten index) cross between the packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = object()


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in JAX order, the structure ``tree_unflatten`` takes)."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(node[key]) for key in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(sub) for sub in node)
        if node is None:
            return None
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(structure, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, dict):
            return {key: build(sub) for key, sub in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return node

    return build(structure)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[[Any], Any], tree) -> Any:
    leaves, structure = tree_flatten(tree)
    return tree_unflatten(structure, [fn(leaf) for leaf in leaves])


def param_count(tree) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(
        leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree)
    )
