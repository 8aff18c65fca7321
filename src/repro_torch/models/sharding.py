"""Logical activation-sharding constraints, the counterpart of the JAX
package's ``repro.models.sharding``.

Model code annotates activations with *logical* axes (``'dp'``,
``'tp'``, ``'flat'``, ``None``); ``_resolve`` and ``_divides`` map them
onto a mesh's named dimensions (a ``torch.distributed.device_mesh.
DeviceMesh`` with axes ``(data, model)`` or ``(pod, data, model)``).

The JAX package reads the mesh that is ambient at trace time; the port
reads the mesh a tensor lies on.  A plain tensor has none: ``constrain``
returns it as it is, as the JAX package does without a mesh.  A DTensor
is redistributed to the placements the logical axes give on its own
``device_mesh``, each dimension that does not divide falling back to
``Replicate()`` as in the JAX package (``_divides``); the counterpart of
``with_sharding_constraint``.
"""
from __future__ import annotations

import math

import torch

_DP_AXES = ("pod", "data")
_TP_AXIS = "model"


def is_dtensor(x) -> bool:
    """Is ``x`` a ``torch.distributed.tensor.DTensor``?"""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def _resolve(mesh, logical):
    names = _names(mesh)
    if logical is None:
        return None
    if logical == "dp":
        axes = tuple(a for a in _DP_AXES if a in names)
        return axes if axes else None
    if logical == "tp":
        return _TP_AXIS if _TP_AXIS in names else None
    if logical == "flat":
        return tuple(names)
    if logical in names:
        return logical
    return None


def _divides(dim: int, axes, mesh) -> bool:
    if axes is None:
        return True
    names = _names(mesh)
    group = axes if isinstance(axes, tuple) else (axes,)
    k = math.prod(int(mesh.size(names.index(a))) for a in group)
    return k > 0 and dim % k == 0


def placements(spec: tuple, mesh) -> tuple:
    """A spec (one entry a tensor dim: an axis name, a tuple of them or
    None, as a ``PartitionSpec``) as DTensor placements, one a mesh
    dimension: ``Shard(i)`` where the dimension, of more than one rank,
    shards tensor dim ``i``, else ``Replicate()`` (an axis of one rank
    cuts nothing: so a 1 x 1 mesh redistributes nothing)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for k, axis in enumerate(_names(mesh)):
        dim = None
        for i, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if axis in axes:
                dim = i
        cut = dim is not None and int(mesh.size(k)) > 1
        out.append(Shard(dim) if cut else Replicate())
    return tuple(out)


def logical_placements(shape, mesh, *logical_axes) -> tuple:
    """The placements ``constrain`` gives a tensor of ``shape`` on
    ``mesh``: each logical axis resolved, and replicated where its mesh
    extent does not divide the dimension."""
    spec = []
    for dim, logical in zip(shape, logical_axes):
        axes = _resolve(mesh, logical)
        spec.append(axes if _divides(int(dim), axes, mesh) else None)
    return placements(tuple(spec), mesh)


def constrain(x, *logical_axes):
    """``with_sharding_constraint`` with logical names: ``x`` itself
    unless it is a DTensor, which is redistributed (where its placements
    differ) to ``logical_placements`` on its own mesh; and, as the JAX
    package's constraint also binds the cotangent, its gradient is laid
    out so too (``pin_grad``)."""
    if x is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(
            f"constrain: {len(logical_axes)} axes for rank-{x.dim()} array"
        )
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = logical_placements(x.shape, mesh, *logical_axes)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return pin_grad(x)


def pin_grad(x):
    """DTensor ``x`` itself, with its gradient redistributed to ``x``'s
    placements before it flows on (a gradient may arrive laid out
    otherwise, e.g. cut over a dim that a view then splits unevenly)."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def mesh_dims_sharding(placements_, tensor_dim: int) -> tuple[int, ...]:
    """The mesh dimensions whose placement shards ``tensor_dim``."""
    return tuple(i for i, p in enumerate(placements_)
                 if p.is_shard() and p.dim == tensor_dim)


def local_box(shape, mesh, placements_) -> tuple[list, list]:
    """``(local shape, global offset)`` of this rank's shard of a tensor
    of ``shape`` under ``placements_`` on ``mesh``: DTensor's ``Shard``
    (``torch.chunk``'s pieces, a dim cut by several mesh dims cut by
    them in mesh order), reckoned on the host (no tensor is made, so it
    holds under a ``FakeTensorMode`` too)."""
    sizes, offsets = [int(n) for n in shape], [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if not p.is_shard():
            continue
        d = p.dim % len(sizes)
        full, k = sizes[d], int(mesh.size(i))
        step = -(-full // k)
        start = min(coord[i] * step, full)
        offsets[d] += start
        sizes[d] = min(full, start + step) - start
    return sizes, offsets


def local_offset(x, tensor_dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along
    ``tensor_dim`` of the global tensor."""
    return local_box(x.shape, x.device_mesh, x.placements)[1][tensor_dim]


def all_reduce_over(t, op: str, mesh, dims) -> torch.Tensor:
    """``t`` (a plain tensor) all-reduced with ``op`` (``"sum"`` or
    ``"max"``) over each mesh dimension in ``dims`` of extent above 1,
    by functional collectives (``_c10d_functional.all_reduce``, what
    the dry-run's trace records); ``t`` itself where there is none."""
    from torch.distributed import _functional_collectives as funcol

    for dim in dims:
        if mesh.size(dim) > 1:
            t = funcol.all_reduce(t, op, (mesh, dim))
    return t


def distribute(t, mesh, placements_):
    """The DTensor of global tensor ``t`` (real or fake, the same on every
    rank) under ``placements_`` on ``mesh``: each rank keeps its own
    shard (a copy where it is a slice or ``t`` a view into more, ``t``
    itself where nothing is cut), with no collective."""
    from torch.distributed.tensor import DTensor

    shape, offset = local_box(t.shape, mesh, placements_)
    local = t.detach()
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    if local.untyped_storage().nbytes() != (local.numel()
                                            * local.element_size()):
        local = local.clone()  # owns its bytes, as a device's shard does
    return DTensor.from_local(local, mesh, tuple(placements_),
                              run_check=False, shape=t.shape,
                              stride=t.stride())
