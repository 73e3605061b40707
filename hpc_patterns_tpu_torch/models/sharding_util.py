"""Mesh-spec helpers: the counterpart of
``hpc_patterns_tpu/models/sharding_util.py`` (``resolve_spec``,
``mesh_axis_size``), over the port's mesh.

A mesh here is a ``{axis: size}`` dict laid out row-major, the form
``comm.Communicator`` and ``comm.fused.mesh_ring_geometry`` take; its
ranks are logical ranks of one device. A spec is a tuple with one entry
per tensor dim, as ``PartitionSpec`` holds them: ``None`` (not sharded),
an axis name, or a tuple of names (the dim split over their product, the
first name major).

:func:`to_ranks` and :func:`from_ranks` are ``shard_map``'s in- and
out-specs on logical ranks: the shards of a global tensor stacked on
leading rank dims (one per named axis, row r of a dim holding rank r's
shard), and back. A rank axis that shards nothing holds the same tensor
on every rank (a broadcast view going in; rank 0's copy coming out).
"""

from __future__ import annotations

import math

import torch


def resolve_spec(spec, mesh: dict, allowed=None) -> tuple:
    """Drop the spec's axes that the mesh does not have (that dim is then
    replicated), so one rule table serves every mesh shape. Tuple entries
    keep only their present members. ``allowed``: the axis names pruning
    is legitimate for (the model config's axes); an absent axis outside
    ``allowed`` is a misconfiguration and raises."""

    def fix(ax):
        if isinstance(ax, tuple):
            kept = tuple(a for a in (fix(a) for a in ax) if a is not None)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        if ax is None or ax in mesh:
            return ax
        if allowed is not None and ax not in allowed:
            raise ValueError(
                f"spec axis {ax!r} is neither in the mesh {tuple(mesh)} nor "
                f"a declared model axis {sorted(allowed)} — axis-name "
                "mismatch?")
        return None

    return tuple(fix(ax) for ax in spec)


def mesh_axis_size(mesh: dict, name: str) -> int:
    """Axis size, 1 when the mesh does not carry the axis."""
    return int(mesh[name]) if name in mesh else 1


def _groups(spec, ndim: int) -> list:
    """Each dim's sharding axes, in spec (major-first) order."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [() if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in spec]


def to_ranks(x: torch.Tensor, spec, mesh: dict, axes) -> torch.Tensor:
    """The shards of ``x`` under a resolved ``spec``, stacked on one
    leading dim per axis of ``axes`` (in that order): ``(*[size of each
    axis], *local shape)``. An axis of ``axes`` that shards no dim (or
    that the mesh lacks: size 1) broadcasts ``x``'s shard over its ranks;
    an axis that shards a dim must be in ``axes``."""
    groups = _groups(spec, x.dim())
    shape, pos = [], {}
    for d, g in enumerate(groups):
        n = math.prod(mesh[a] for a in g)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over {g} ({n} ranks)")
        for a in g:
            pos[a] = len(shape)
            shape.append(mesh[a])
        shape.append(x.shape[d] // n)
    if set(pos) - set(axes):
        raise ValueError(f"spec {tuple(spec)} shards over "
                         f"{sorted(set(pos) - set(axes))}, outside the rank "
                         f"axes {tuple(axes)}")
    local = [i for i in range(len(shape)) if i not in pos.values()]
    y = x.reshape(shape).permute([pos[a] for a in axes if a in pos] + local)
    for i, a in enumerate(axes):
        if a not in pos:
            y = y.unsqueeze(i)
    return y.expand(*(mesh_axis_size(mesh, a) for a in axes),
                    *y.shape[len(axes):])


def from_ranks(y: torch.Tensor, spec, mesh: dict, axes,
               keep=()) -> torch.Tensor:
    """The inverse of :func:`to_ranks`: the global tensor from its stacked
    shards (rank 0's copy along an axis that shards nothing). ``keep``: a
    subset of ``axes`` to leave stacked (in ``keep``'s order) while every
    other rank axis is gathered — an fsdp all-gather that keeps the tp
    shards, say. A kept axis must come before the gathered ones of a dim
    it shares (major), so each kept rank's slab is whole."""
    axes = tuple(axes)
    keep = tuple(keep)
    if set(keep) - set(axes):
        raise ValueError(f"keep {keep} is not within the rank axes {axes}")
    groups = _groups(spec, y.dim() - len(axes))
    used = {a for g in groups for a in g}
    y = y[tuple(slice(None) if a in used or a in keep else 0 for a in axes)]
    names = [a for a in axes if a in used or a in keep]
    k = len(names)
    perm = [names.index(a) for a in keep]
    shape = [y.shape[names.index(a)] for a in keep]
    for d, g in enumerate(groups):
        gathered = [a for a in g if a not in keep]
        if any(g.index(a) > g.index(b) for a in g if a in keep
               for b in gathered):
            raise ValueError(f"dim {d} is sharded over {g}: kept axes "
                             f"{keep} must be its major ones")
        perm += [names.index(a) for a in gathered] + [k + d]
        shape.append(math.prod(mesh[a] for a in gathered) * y.shape[k + d])
    return y.permute(perm).reshape(shape)


def rank_axes(spec, mesh: dict) -> tuple:
    """The mesh axes (in the mesh's order) a resolved ``spec`` shards
    over: the leading rank dims of a tensor stored as its stacked shards
    (:func:`to_ranks` over exactly these axes, so an axis that shards
    nothing adds no dim and a replicated tensor is stored once)."""
    used = {a for g in _groups(spec, len(tuple(spec))) for a in g}
    return tuple(a for a in mesh if a in used)


def is_stacked(leaf: torch.Tensor, spec) -> bool:
    """Whether ``leaf`` is stored as rank-stacked shards (more dims than
    its spec's global shape) rather than as the global tensor: the one
    test of a leaf's storage form."""
    return leaf.dim() > len(tuple(spec))


def shard_at(y: torch.Tensor, spec, mesh: dict, coord: dict) -> torch.Tensor:
    """The shard a rank at mesh coordinate ``coord`` (``{axis: index}``)
    holds of a tensor stored stacked over ``rank_axes(spec, mesh)``."""
    return y[tuple(int(coord.get(a, 0)) for a in rank_axes(spec, mesh))]
