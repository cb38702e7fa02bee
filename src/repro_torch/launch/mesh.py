"""Meshes of ``torch.distributed`` ranks (twin of ``repro.launch.mesh``).

A :class:`Mesh` is a named grid of the world's ranks, ``("data",
"model")`` or ``("pod", "data", "model")``, laid out row-major (the last
axis varies fastest: on a ``(2, 2)`` mesh ranks 0 and 1 share a data
index and differ in model), as ``jax.make_mesh`` lays out its devices.
It holds a process group for every line of every set of its axes (the
ranks that differ only along those axes), made with ``dist.new_group``
when the mesh is made, on every rank in the same order.  A mesh of one
rank needs no process group: every collective over it is the identity.

:func:`set_mesh` scopes a mesh as the reference's does (a context
manager); the model code reads it through ``distributed.sharding``.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist


class Mesh:
    """A grid of the world's ranks with named axes.

    ``axis_names`` / ``axis_sizes`` as the reference's mesh;
    ``coords[axis]`` is this rank's index along ``axis``;
    ``group(axes)`` the process group of this rank's line along
    ``axes`` (a name or a tuple of names; None where the line is this
    rank alone), whose group rank is the rank's index in the line, the
    axes ordered as the mesh orders them (the first major)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.axis_sizes: Tuple[int, ...] = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             "in length")
        self.size = 1
        for s in self.axis_sizes:
            self.size *= s
        self.rank = rank
        self.coords: Dict[str, int] = {}
        r = rank
        for name, s in reversed(list(zip(self.axis_names,
                                         self.axis_sizes))):
            self.coords[name] = r % s
            r //= s
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or names; an axis
        the mesh lacks counts 1)."""
        sizes = self.shape
        n = 1
        for a in _names(axes):
            n *= sizes.get(a, 1)
        return n

    def index(self, axes) -> int:
        """This rank's index along ``axes`` taken together, in the order
        given (the first major)."""
        i = 0
        for a in _names(axes):
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axes):
        """The process group of this rank's line along ``axes``; None if
        the line holds this rank alone."""
        key = self._ordered(axes)
        if self.axis_size(key) == 1:
            return None
        if key not in self._groups:
            raise KeyError(f"mesh has no group over {key}")
        return self._groups[key]

    def _ordered(self, axes) -> Tuple[str, ...]:
        want = set(_names(axes))
        return tuple(a for a in self.axis_names if a in want)

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for name, s in zip(self.axis_names, self.axis_sizes):
            r = r * s + coords[name]
        return r

    def _make_groups(self) -> None:
        """Every line of every non-empty set of axes, each made by every
        rank in the same order (``dist.new_group`` requires it)."""
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if self.axis_size(axes) == 1:
                    continue
                if self.axis_size(axes) == self.size:
                    self._groups[axes] = dist.group.WORLD
                    continue
                rest = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    c = dict(zip(rest, fixed))
                    ranks = []
                    for idx in itertools.product(
                            *(range(self.shape[a]) for a in axes)):
                        c.update(zip(axes, idx))
                        ranks.append(self._rank_of(c))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the world of
    ``torch.distributed``'s default group (every rank must call it, in
    the same order as its other collectives); a mesh of one rank without
    an initialised group.  A world of another size than the mesh
    raises."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a mesh of shape {shape} needs a world of {n} "
                         f"ranks, not {world}")
    mesh = Mesh(shape, axes, dist.get_rank() if dist.is_initialized()
                else 0)
    if n > 1:
        mesh._make_groups()
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks.  Made only on a
    world of that size: on any other world it raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


_CURRENT: list = []


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Scope ``mesh`` as the current one (``None``: no mesh)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`set_mesh`, or None."""
    return _CURRENT[-1] if _CURRENT else None


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_size(mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    return sizes.get("model", 1)
