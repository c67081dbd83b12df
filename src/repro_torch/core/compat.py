"""The rank-stacked SPMD region: the port's counterpart of the
reference's ``shard_map`` / ``make_mesh`` facade
(``src/repro/core/compat.py``).

The reference runs a function once on every device of a mesh
(``jax.shard_map``), each device holding its own shard. On one card the
port runs the function ONCE on all shards stacked: inside a region every
per-rank value carries a leading rank dimension ``R`` (the mesh's size).
Ranks are stacked in the row-major order of the input spec's axis tuple
(process-major for ``P(unified_axes)``, as JAX linearises it), followed by
any mesh axis the spec does not name. So, for a function handed to
``shard_map`` or ``ThreadComm.run``:

* a local shard of shape ``s`` arrives as ``(R, *s)``;
* a per-rank scalar (a rank index, a dot product) is ``(R,)``, and meets
  an ``(R, ...)`` tensor only through :func:`rank_view`;
* messages and collectives (``core.collectives``) act over dim 0.

A thread-local current region (mesh and stacked axis order) lets the
collectives work out families and local ranks. There is no ``vmap``: the
message kernels take real pointers.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

Axes = Union[str, Tuple[str, ...]]


class P(tuple):
    """PartitionSpec stand-in. ``P(axes)`` splits dim 0 over ``axes`` (a
    mesh-axis name or a tuple of names); ``P()`` and ``P(None)``
    replicate. Only dim 0 is ever split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def axes(self) -> Tuple[str, ...]:
        if any(e is not None for e in self[1:]):
            raise NotImplementedError(f"{self}: only dim 0 can be split")
        if not self or self[0] is None:
            return ()
        return _axes(self[0])


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over the ranks of one device. ``devices`` is the rank
    grid (as ``jax.sharding.Mesh.devices``: the comm layer reads its
    shape); ``device`` is where every stacked tensor lives."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        self.devices = np.arange(self.size).reshape(tuple(shape))
        self.device = torch.device(device)
        self._regions: Dict[Tuple[str, ...], "Region"] = {}

    def region(self, order: Tuple[str, ...]) -> "Region":
        """The region stacking this mesh's ranks in ``order``, made once:
        its index tables reach the device once, not on every call."""
        if order not in self._regions:
            self._regions[order] = Region(self, order)
        return self._regions[order]

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh of ranks on one device: the card unless the caller asks for
    the CPU; raises when it names the card and there is none."""
    return Mesh(shape, names, resolve_device(device))


class Region:
    """One rank-stacked region: the mesh and the order of its stacked
    axes, with host tables of each stacked rank's coordinates and their
    device copies (cached: a copy to the card would stall the host)."""

    def __init__(self, mesh: Mesh, order: Tuple[str, ...]):
        self.mesh, self.order = mesh, order
        self.size = mesh.size
        sizes = [mesh.shape[a] for a in order]
        grid = np.unravel_index(np.arange(self.size), sizes)
        self._coords = dict(zip(order, grid))
        self._cache: Dict = {}

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.mesh.shape[a] for a in _axes(axes))

    def index(self, axes: Axes) -> np.ndarray:
        """(R,) row-major index of each stacked rank over ``axes``."""
        r = np.zeros(self.size, np.int64)
        for a in _axes(axes):
            r = r * self.mesh.shape[a] + self._coords[a]
        return r

    def memo(self, key, make):
        """``make()``, made once per ``key`` for this region."""
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def on_device(self, key, make) -> torch.Tensor:
        """The host table ``make()`` on the mesh's device, made once."""
        return self.memo(key, lambda: torch.as_tensor(
            make(), device=self.mesh.device))

    def axis_index(self, axes: Axes) -> torch.Tensor:
        return self.on_device(("axis_index", _axes(axes)),
                              lambda: self.index(axes))

    def family(self, axes: Axes):
        """Families over ``axes`` (ranks agreeing on every other mesh axis)
        as ``(members, fam)``: ``members`` (F, k) holds each family's
        stacked ranks by local rank, ``fam`` (R,) each rank's family."""
        axes = _axes(axes)
        key = ("family", axes)
        if key not in self._cache:
            comp = tuple(a for a in self.mesh.axis_names if a not in axes)
            fam, local = self.index(comp), self.index(axes)
            members = np.lexsort((local, fam)).reshape(
                self.size // self.axis_size(axes), -1)
            self._cache[key] = (members, fam)
        return self._cache[key]

    def pairs(self, axes: Axes, local_pairs) -> list:
        """Local-rank (src, dst) pairs, applied in every family, as stacked
        rank pairs."""
        members, _ = self.family(axes)
        return [(int(f[s]), int(f[d])) for f in members
                for s, d in local_pairs]

    def grouped(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """x (R, ...) as (F, k, ...): families by local rank."""
        members, _ = self.family(axes)
        flat = members.reshape(-1)
        if not np.array_equal(flat, np.arange(self.size)):
            x = x[self.on_device(("grouped", _axes(axes)), lambda: flat)]
        return x.reshape(members.shape + tuple(x.shape[1:]))

    def ungrouped(self, g: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Inverse of :meth:`grouped`: (F, k, ...) back to (R, ...)."""
        members, _ = self.family(axes)
        flat = members.reshape(-1)
        x = g.reshape((self.size,) + tuple(g.shape[2:]))
        if np.array_equal(flat, np.arange(self.size)):
            return x
        return x[self.on_device(("ungrouped", _axes(axes)),
                                lambda: np.argsort(flat))]

    def per_family(self, v: torch.Tensor, axes: Axes) -> torch.Tensor:
        """A per-family value (F, ...) handed to each rank: (R, ...)."""
        _, fam = self.family(axes)
        if v.shape[0] == 1:
            return v.expand((self.size,) + tuple(v.shape[1:]))
        return v[self.on_device(("per_family", _axes(axes)), lambda: fam)]


_state = threading.local()


def current_region() -> Region:
    stack = getattr(_state, "regions", None)
    if not stack:
        raise RuntimeError("a collective ran outside a rank-stacked region "
                           "(call it inside shard_map or ThreadComm.run)")
    return stack[-1]


def axis_index(axes: Axes) -> torch.Tensor:
    """int64 (R,): each stacked rank's row-major index over ``axes``."""
    return current_region().axis_index(axes)


def rank_view(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-rank value (R,) viewed as (R, 1, ..., 1) against an (R, ...)
    tensor, so it broadcasts rank by rank and never to (R, R, ...)."""
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def _per_arg(specs, n: int) -> tuple:
    if isinstance(specs, P):
        return (specs,) * n
    specs = tuple(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def _split(a, spec: P, region: Region) -> torch.Tensor:
    a = torch.as_tensor(a, device=region.mesh.device)
    axes = spec.axes()
    if not axes:
        return a.unsqueeze(0).expand((region.size,) + tuple(a.shape))
    k = region.axis_size(axes)
    if a.dim() == 0 or a.shape[0] % k:
        raise ValueError(f"dim 0 of a {tuple(a.shape)} input does not split "
                         f"over {axes} ({k} ranks)")
    chunks = a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))
    idx = region.index(axes)
    if np.array_equal(idx, np.arange(region.size)):
        return chunks
    return chunks[region.axis_index(axes)]


def _assemble(v: torch.Tensor, spec: P, region: Region) -> torch.Tensor:
    if v.dim() == 0 or v.shape[0] != region.size:
        raise ValueError(f"a region returned {tuple(v.shape)}, not a "
                         f"per-rank (R={region.size}, ...) value")
    axes = spec.axes()
    if not axes:
        return v[0]
    if v.dim() < 2:
        raise ValueError(f"out spec {spec} needs a local shape of rank >= 1")
    first = np.unique(region.index(axes), return_index=True)[1]
    if not np.array_equal(first, np.arange(region.size)):   # a rank a chunk
        v = v[region.on_device(("first", axes), lambda: first)]
    return v.reshape((v.shape[0] * v.shape[1],) + tuple(v.shape[2:]))


def shard_map(f, *, mesh: Mesh, in_specs, out_specs):
    """Run ``f`` once over the rank-stacked shards of its inputs (see the
    module docstring) and reassemble its outputs: ``P(axes)`` concatenates
    the ranks' shards along dim 0, ``P()`` / ``P(None)`` takes rank 0's.
    Every mesh axis is stacked (the reference's fully manual region)."""

    def run(*args):
        specs = _per_arg(in_specs, len(args))
        named = next((s.axes() for s in specs if s.axes()), ())
        order = named + tuple(a for a in mesh.axis_names if a not in named)
        region = mesh.region(order)
        stacked = [_split(a, s, region) for a, s in zip(args, specs)]
        stack = _state.__dict__.setdefault("regions", [])
        stack.append(region)
        try:
            out = f(*stacked)
        finally:
            stack.pop()
        if isinstance(out, (tuple, list)):
            return tuple(_assemble(v, s, region) for v, s in
                         zip(out, _per_arg(out_specs, len(out))))
        return _assemble(out, out_specs, region)

    return run
