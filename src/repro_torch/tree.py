"""Nested containers of tensors, flattened in ``jax.tree``'s order.

The port keeps the JAX package's pytrees as plain Python containers: a
dict (its keys sorted, as ``jax.tree`` sorts them), a list, a tuple or a
named tuple is a node; ``None`` is a node with no leaves; anything else is
a leaf. A leaf's path is the tuple of its dict keys, sequence indices and
named-tuple field names from the root, as ``tree_flatten_with_path``
gives it.

The walks are module-level functions that take what they read as
arguments: a closure that names itself is a reference cycle, which would
keep whatever the walk saw (the leaves, ``fn``, the iterator over new
leaves) alive until the cyclic collector runs.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten_with_paths", "leaves", "structure_str", "tree_map",
           "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[Any, Any]] | None:
    """``[(path entry, child), ...]`` of a node in flatten order; None for
    a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, children: list):
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)._make(children)
    return type(node)(children)


def _node_children(node, is_leaf):
    if is_leaf is not None and is_leaf(node):
        return None
    return _children(node)


def _child(node, entry):
    return getattr(node, entry) if _is_namedtuple(node) else node[entry]


def flatten_with_paths(tree, is_leaf=None) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree_util.tree_flatten_with_path``
    order; ``is_leaf(node)`` true stops the walk at ``node``."""
    out = []
    _walk(tree, (), is_leaf, out)
    return out


def _walk(node, path, is_leaf, out) -> None:
    kids = _node_children(node, is_leaf)
    if kids is None:
        out.append((path, node))
        return
    for entry, child in kids:
        _walk(child, path + (entry,), is_leaf, out)


def leaves(tree, is_leaf=None) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the structure holds")
    return out


def _build(node, it):
    kids = _children(node)
    if kids is None:
        return next(it)
    return _rebuild(node, [_build(c, it) for _, c in kids])


_END = object()


def tree_map(fn: Callable, tree, *rest, is_leaf=None) -> Any:
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and, from each
    of ``rest``, the subtree at the same place (``tree``'s structure is a
    prefix of theirs)."""
    return _map(fn, tree, list(rest), is_leaf)


def _map(fn, node, others, is_leaf):
    kids = _node_children(node, is_leaf)
    if kids is None:
        return fn(node, *others)
    for o in others:
        if type(o) is not type(node) or (
                isinstance(node, dict) and sorted(o) != sorted(node)) or (
                isinstance(node, (list, tuple)) and len(o) != len(node)):
            raise ValueError(f"tree structures differ: {type(node)} "
                             f"against {type(o)}")
    return _rebuild(node, [_map(fn, c, [_child(o, e) for o in others],
                                is_leaf) for e, c in kids])


def structure_str(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` writes
    it, e.g. ``PyTreeDef({'a': *, 'b': [*, None]})``."""
    return f"PyTreeDef({_fmt(tree)})"


def _fmt(node) -> str:
    kids = _children(node)
    if kids is None:
        return "*"
    if node is None:
        return "None"
    parts = [_fmt(c) for _, c in kids]
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {p}"
                               for (k, _), p in zip(kids, parts)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(parts) + "]"
    if _is_namedtuple(node):
        return (f"{type(node).__name__}(" + ", ".join(
            f"{k}={p}" for (k, _), p in zip(kids, parts)) + ")")
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
