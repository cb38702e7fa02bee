"""Param-tree walking and key-path formatting (twin of
``repro.core.treepath``, with the traversal ``jax.tree_util`` gives the
reference).

A port tree is nested dicts, lists, tuples and NamedTuples (such as
``optim.AdamWState``) whose leaves are tensors (or numpy arrays); ``None``
is an empty subtree, as in JAX.  A key path is a tuple of entries of the
three kinds ``jax.tree_util`` yields — :class:`DictKey` (``.key``),
:class:`SequenceKey` (``.idx``), :class:`GetAttrKey` (``.name``, a
NamedTuple field) — so :func:`path_parts` gives the reference's string for
every entry, and a checkpoint written by either package names its leaves
alike.  Dict keys are visited in sorted order, as JAX visits them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str


def path_parts(path) -> list:
    """One plain string per key-path entry."""
    out = []
    for e in path:
        if hasattr(e, "key"):
            out.append(str(e.key))
        elif hasattr(e, "idx"):
            out.append(str(e.idx))
        elif hasattr(e, "name"):
            out.append(str(e.name))
        else:
            out.append(str(e))
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """``[(entry, child), ...]`` of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(DictKey(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(GetAttrKey(f), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(SequenceKey(i), c) for i, c in enumerate(tree)]
    return None


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None
                           ) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's order (``None`` has no leaf)."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) \
        else _children(tree)
    if kids is None:
        return [((), tree)]
    return [((entry,) + path, leaf) for entry, child in kids
            for path, leaf in tree_flatten_with_path(child, is_leaf)]


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that
    structure."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, c, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, c in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten_like(template, leaves_by_path: Callable):
    """A tree of ``template``'s structure whose leaf at each path is
    ``leaves_by_path(path, template_leaf)``."""
    def build(tree, path):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: build(v, path + (DictKey(k),))
                    for k, v in tree.items()}
        kids = _children(tree)
        if kids is None:
            return leaves_by_path(path, tree)
        built = [build(child, path + (entry,)) for entry, child in kids]
        if _is_namedtuple(tree):
            return type(tree)(*built)
        return type(tree)(built)
    return build(template, ())
