"""Logical activation-sharding constraints, the counterpart of the JAX
package's ``repro.models.sharding``.

Model code annotates activations with *logical* axes (``'dp'``,
``'tp'``, ``'flat'``, ``None``); ``_resolve`` and ``_divides`` map them
onto a mesh's named dimensions (a ``torch.distributed.device_mesh.
DeviceMesh``, as ``launch.mesh.make_production_mesh`` builds).

Eager torch has no SPMD partitioner and no ambient mesh a trace could
read, so ``constrain`` is what the JAX package's is on a single device:
it checks that one axis is named per dimension and returns ``x``
unchanged.  The sharded LM (DTensor placements over a mesh) is a later
ROADMAP item.
"""
from __future__ import annotations

import math

_DP_AXES = ("pod", "data")
_TP_AXIS = "model"


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


def constrain(x, *logical_axes):
    """The JAX package's ``constrain`` on one device: ``x`` itself, after
    checking that ``logical_axes`` names one axis per dimension."""
    if x is None:
        return x
    if len(logical_axes) != x.dim():
        raise ValueError(
            f"constrain: {len(logical_axes)} axes for rank-{x.dim()} array"
        )
    return x
