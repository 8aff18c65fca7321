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


def row_mesh(mesh, placements_):
    """The 1-D mesh over the dimensions of ``mesh`` whose placement
    shards tensor dim 0, those of extent 1 left out, flattened in mesh
    order (the order in which ``Shard(0)`` on several dimensions nests
    its pieces: the flattened rank is the index of this rank's rows);
    None where no such dimension cuts the rows.  Made once a mesh and
    set of dimensions (``DeviceMesh._flatten``: one process group over
    them, so a collective over the rows is one call, not one a mesh
    dimension)."""
    dims = tuple(i for i in mesh_dims_sharding(placements_, 0)
                 if mesh.size(i) > 1)
    if not dims:
        return None
    # Kept on the mesh itself: a cache keyed by meshes would take a later
    # group's equal mesh for this one.
    kept = mesh.__dict__.setdefault("_row_meshes", {})
    if dims not in kept:
        from torch.utils._python_dispatch import _disable_current_modes

        names = tuple(mesh.mesh_dim_names[i] for i in dims)
        # Built on the mesh's real rank tensor: outside a trace's fake
        # mode and its counter.
        with _disable_current_modes():
            kept[dims] = (mesh[names[0]] if len(names) == 1
                          else mesh[names]._flatten())
    return kept[dims]


def waited(t):
    """A functional collective's result, waited on (its plain tensor)."""
    return t.wait() if hasattr(t, "wait") else t


def all_gather_rows(t, rows) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in ``rows``' rank order,
    by one functional all-gather over the 1-D mesh ``rows``."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return waited(gather(t.contiguous(), 0, rows))


def reduce_scatter_rows(t, rows) -> torch.Tensor:
    """``t`` summed over the ranks of the 1-D mesh ``rows``, this rank's
    piece of dim 0 kept (the rows ``all_gather_rows`` would put at its
    rank), by one functional reduce-scatter."""
    from torch.distributed import _functional_collectives as funcol

    scatter = getattr(funcol, "reduce_scatter_single", None) or \
        funcol.reduce_scatter_tensor
    return waited(scatter(t.contiguous(), "sum", 0, rows))


def replicate_like(t, like):
    """Plain tensor ``t`` (a constant: a table, an index range) as a
    DTensor replicated on ``like``'s mesh where ``like`` is a DTensor,
    so that the two can meet in one op; ``t`` itself otherwise."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def rows_einsum(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum(equation, *operands)`` whose first operand's dim 0
    (edges or nodes) is the output's dim 0.  On a DTensor first operand
    each rank contracts its own rows under ``local_map``, no collective:
    an operand laid out as the first keeps its rows, a replicated one
    (a weight) takes ``Partial`` gradients over the rows' cut, a plain
    one (a constant table) passes as it is.  DTensor's own einsum
    decomposes a three-operand product into views that some torch
    versions shape at the global size over a rank's rows."""
    first = operands[0]
    if not is_dtensor(first):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = first.device_mesh, tuple(first.placements)
    whole = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    in_pl, grad_pl = [], []
    for x in operands:
        rows = is_dtensor(x) and tuple(x.placements) == pl
        in_pl.append(pl if rows else whole if is_dtensor(x) else None)
        grad_pl.append(pl if rows else summed if is_dtensor(x) else None)
    return local_map(lambda *xs: torch.einsum(equation, *xs),
                     out_placements=list(pl), in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*operands)


def zeros_like_rows(like, shape, dtype):
    """``torch.zeros(shape, dtype)`` on ``like``'s device; for a DTensor
    ``like``, a DTensor under ``like``'s placements (rows laid out as
    its rows: each rank makes its own)."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros

    return zeros(*shape, dtype=dtype, device_mesh=like.device_mesh,
                 placements=like.placements)


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
