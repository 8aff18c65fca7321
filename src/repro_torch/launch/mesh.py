"""Process groups and the 1-D mesh the distributed backends run over.

The JAX package builds a ``jax.sharding.Mesh`` over the devices one
process sees.  The port runs one process per rank, so its mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over a world that is
already initialised, its one dimension named by ``ExecutionConfig.axis``
(``"data"``).  On the card the group is NCCL (one rank per card: NCCL
refuses two ranks on one device); on the CPU it is ``gloo``.

* ``init_local_group`` forms a group from a ``FileStore`` (no TCP port,
  no ``env://``, nothing written to ``os.environ``), with an explicit
  timeout, so a rank that never arrives, or a collective one rank never
  joins, raises on every rank instead of hanging.
* ``spawn_ranks`` runs ``fn(rank, world, *args)`` in ``world`` fresh
  ``spawn`` processes, each on one thread, and kills them all when one
  of them fails or a deadline, if given, passes.
* ``make_host_mesh`` wraps the initialised world in the mesh.
* ``make_mesh`` is a ``(data, model)`` or ``(pod, data, model)`` mesh of
  any shape over the whole initialised world (the counterpart of
  ``jax.make_mesh``): the partitioned LM's mesh on the CPU's ``gloo``
  ranks and on the card (an NCCL group of one: a 1 x 1 mesh).
* ``mesh_shape`` is a stand-in of a mesh: its shape and axis names,
  no ranks; ``launch.tasks`` traces a cell's whole global step on one
  (the trace a partitioned one is held against).
* ``make_production_mesh`` is the LM side's 2-D ``(data, model)`` or
  3-D ``(pod, data, model)`` mesh of the JAX package's production
  layout (16 x 16, or 2 x 16 x 16 across two pods), over the first
  ranks of a world at least that large; ``dp_axes``, ``flat_axes`` and
  ``total_devices`` read a mesh's axes as the JAX package's do.
* ``init_fake_world`` makes this one process rank 0 of a world of any
  size on torch's ``fake`` backend (its collectives do nothing), so the
  production meshes can be built without their ranks: the dry-run's
  counterpart of the JAX package's 512 forced host devices.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import time

import torch
import torch.distributed as dist

# A group's collectives raise after this long without every rank (the
# ceiling ``init_local_group`` enforces).
MAX_GROUP_TIMEOUT_S = 60.0


def init_local_group(rank: int, world: int, store_dir: str, device,
                     timeout_s: float = MAX_GROUP_TIMEOUT_S):
    """Join rank ``rank`` of ``world`` to the default process group.

    The ranks meet in a ``FileStore`` under ``store_dir`` (every rank
    passes the same directory; it must start empty of a former group's
    store file).  ``device`` picks the backend: ``nccl`` for ``cuda``
    (the rank's card is ``cuda:rank``), ``gloo`` for the CPU.  Returns
    the device the rank runs on.
    """
    if not 0 < timeout_s <= MAX_GROUP_TIMEOUT_S:
        raise ValueError(f"timeout_s must lie in (0, {MAX_GROUP_TIMEOUT_S}]")
    dev = torch.device(device)
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise ValueError(
                f"{world} ranks need {world} cards, "
                f"{torch.cuda.device_count()} visible: NCCL takes one rank "
                "per device"
            )
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    os.makedirs(store_dir, exist_ok=True)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    return dev


def init_fake_world(world: int) -> None:
    """Make this process rank 0 of a world of ``world`` ranks on the
    ``fake`` process-group backend (``torch.testing``'s ``FakeStore`` and
    ``FakeProcessGroup``: no other rank exists, and every collective
    returns at once without moving data).  For tracing on fake tensors
    only; the caller destroys the group
    (``torch.distributed.destroy_process_group``) when done."""
    # Importing the module registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world))


def make_host_mesh(n_devices: int | None = None, axis: str = "data"):
    """A 1-D ``DeviceMesh`` named ``axis`` over the initialised world.

    ``n_devices`` must be the world size (``None``: the world size): a
    mesh over fewer ranks would need a subgroup every rank creates.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call init_local_group (or "
            "torch.distributed.init_process_group) first"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a host mesh spans the whole world: n_devices={n}, world "
            f"size {world}"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def make_mesh(shape, axes=None):
    """A ``DeviceMesh`` of ``shape`` over every rank of the initialised
    world (row-major: the last axis varies fastest, as ``jax.make_mesh``
    lays devices out), its axes ``(data, model)`` for two dimensions and
    ``(pod, data, model)`` for three unless ``axes`` names them.  Raises
    when no group is initialised or the shape does not cover the world
    exactly."""
    import math

    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(n) for n in shape)
    if axes is None:
        axes = {2: ("data", "model"),
                3: ("pod", "data", "model")}.get(len(shape))
        if axes is None:
            raise ValueError(f"name the axes of a {len(shape)}-D mesh")
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} axis names for a {len(shape)}-D mesh")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call init_local_group (or "
            "torch.distributed.init_process_group) first"
        )
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, the "
                         f"world {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: ``(data=16, model=16)``, or ``(pod=2,
    data=16, model=16)`` with ``multi_pod``, as a ``DeviceMesh`` over
    ranks ``0 .. n - 1`` of the initialised world.  Raises when the
    world holds fewer ranks than the mesh needs (or none is
    initialised), as the JAX package raises on too few devices."""
    import math

    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices but only {world} "
            "are visible: start that many ranks (one per card) and "
            "initialise the process group before building it"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


class MeshShape:
    """A mesh's shape and axis names, with no ranks: what ``launch.tasks``
    reads of a mesh (``mesh_dim_names``, ``size``)."""

    def __init__(self, dims, names):
        self.dims = tuple(int(n) for n in dims)
        self.mesh_dim_names = tuple(names)

    def size(self, dim: int | None = None) -> int:
        import math

        return math.prod(self.dims) if dim is None else self.dims[dim]

    def __repr__(self) -> str:
        return f"MeshShape({self.dims}, {self.mesh_dim_names})"


def mesh_shape(mesh) -> MeshShape:
    """The stand-in of ``DeviceMesh`` ``mesh``: its shape and axis
    names."""
    return MeshShape(mesh.mesh.shape, mesh.mesh_dim_names)


def _axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def dp_axes(mesh) -> tuple:
    """Axes carrying data parallelism (pod x data when multi-pod)."""
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def flat_axes(mesh) -> tuple:
    """Every mesh axis flattened (GNN node/edge sharding)."""
    return _axis_names(mesh)


def total_devices(mesh) -> int:
    """The ranks the mesh spans."""
    return int(mesh.size())


def mesh_size(mesh, axis: str) -> int:
    """The extent of ``mesh`` along the named dimension ``axis``."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return int(mesh.size(names.index(axis)))


def _child(fn, rank, world, args):
    torch.set_num_threads(1)
    fn(rank, world, *args)


def spawn_ranks(fn, world: int, args: tuple = (), *,
                deadline_s: float | None = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` ``spawn`` processes.

    ``fn`` must be importable by name (a module-level function).  Each
    child sets ``torch.set_num_threads(1)`` before any work.  Raises
    ``RuntimeError`` when a child exits non-zero or ``deadline_s``
    passes (``None``: no deadline); either way every child still
    running is killed first.
    """
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    end = None if deadline_s is None else time.monotonic() + deadline_s
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            bad = [p for p in procs
                   if p.exitcode is not None and p.exitcode != 0]
            if bad:
                failed = f"rank {procs.index(bad[0])} exited {bad[0].exitcode}"
                break
            if end is not None and time.monotonic() > end:
                failed = f"ranks still running after {deadline_s:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5.0)
    if failed is None:
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            failed = f"rank exit codes {codes}"
    if failed is not None:
        raise RuntimeError(f"spawn_ranks: {failed}")
