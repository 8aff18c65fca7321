"""Superstep checkpoint/resume: the engine-side analogue of lineage (the
port's counterpart of the JAX package's ``repro.faults.checkpoint``).

MESH-on-Spark replays a lost executor's superstep from RDD lineage; the
equivalent here is snapshotting the loop state — ``(step, v_attr,
he_attr, msg, halted)`` — every ``checkpoint_every`` superstep pairs, so
a killed process resumes mid-algorithm instead of restarting.

Bitwise contract (tested): ``checkpointed_compute`` runs the SAME pair
and loop as ``compute`` (``engine.compute_resumable``: ``pair_in_place``
under ``halting_loop``), split into host-side chunks of ``every`` pairs
with the state threaded through.  The layouts, the kernel's launch plans
and the pair order are the uninterrupted run's; a chunk boundary adds
one host read of ``halted`` and a copy of the state to the host.  Running
k1 pairs, snapshotting, and running k2 more therefore executes the
identical computation in the identical order as one ``k1 + k2`` run —
resumed results are bitwise equal, on the card too (the fused delivery
kernel uses no atomics).  The snapshot also carries the activity trace
of the pairs done, so a resumed run's trace is the uninterrupted run's
(the JAX package's resumed trace holds only the pairs run after the
restore).

Snapshots keep the JAX package's training-checkpoint format
(``repro/train/checkpoint.py``), copied here: one ``.npy`` per leaf, a
JSON manifest with each leaf's name, shape, dtype and sha256, an atomic
``.tmp``-then-rename publish, and ``latest_checkpoint``'s crash-loop
restart semantics.  A bfloat16 leaf, which numpy has no dtype for, is
saved by its bits (int16) under the dtype name ``bfloat16``.  A
checkpoint that fails to restore (corrupt, foreign, wrong shapes or
dtypes) degrades gracefully: the run restarts from superstep 0 rather
than raising.  A restored state lands on the device of the run's
hypergraph (the Engine's).

``checkpointed_distributed_compute`` is the distributed form: one
snapshot holds the full padded loop state (the blocks of the
``sharded`` backend gathered first), rank 0 writes it and every rank
waits at a barrier, so each restores the same snapshot; the
``checkpoint.chunk`` point fires after the same chunk on every rank (each
rank's injector runs the same plan).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.core.api import tree_map
from repro_torch.core.engine import compute_resumable, initial_superstep_state
from repro_torch.faults.errors import CheckpointError
from repro_torch.obs.trace import maybe_span

# --------------------------------------------------------------------------
# the snapshot format
# --------------------------------------------------------------------------


def _flatten(tree, path: str = "") -> list:
    """``(name, leaf)`` pairs in the JAX package's flatten order (dict
    keys sorted) and key-path names (``['v_attr']/[0]``); ``None`` is an
    empty subtree."""
    if tree is None:
        return []
    sep = "/" if path else ""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}{sep}[{k!r}]")]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree)
                for item in _flatten(x, f"{path}{sep}[{i}]")]
    return [(path, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (an iterator, in
    ``_flatten`` order) in place of its leaves."""
    if template is None:
        return None
    if isinstance(template, dict):
        made = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: made[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(x, leaves) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its dtype name.  Host ints are the
    superstep counter (int32, as in the JAX package), host bools the
    halt flag; bfloat16 goes by its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
        return arr, arr.dtype.name
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_), "bool"
    arr = np.asarray(leaf, np.int32)
    return arr, arr.dtype.name


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty((), dtype=leaf.dtype).numpy().dtype.name
    return "bool" if isinstance(leaf, (bool, np.bool_)) else "int32"


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Atomically persist ``tree`` for ``step``; returns the final path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "name": name,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
            "sha256_16": _digest(arr),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The highest complete step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    if not steps:
        return None
    return os.path.join(ckpt_dir, sorted(steps)[-1])


def restore_checkpoint(path: str, template) -> tuple[Any, int]:
    """Restore into the structure of ``template``, each tensor on its
    template leaf's device; returns ``(tree, step)``.  Raises
    ``CheckpointError`` on a snapshot that does not fit: another leaf
    count, a hash, shape or dtype mismatch."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    expected = _flatten(template)
    metas = manifest["leaves"]
    if len(metas) != len(expected):
        raise CheckpointError(
            f"checkpoint has {len(metas)} leaves, expected {len(expected)}"
        )
    out = []
    for (name, like), meta in zip(expected, metas):
        arr = np.load(os.path.join(path, meta["file"]))
        if _digest(arr) != meta["sha256_16"]:
            raise CheckpointError(
                f"checkpoint leaf {meta['name']} corrupt (hash mismatch)"
            )
        is_tensor = isinstance(like, torch.Tensor)
        want_shape = tuple(like.shape) if is_tensor else ()
        want_dtype = _dtype_name(like)
        if tuple(arr.shape) != want_shape or meta["dtype"] != want_dtype:
            raise CheckpointError(
                f"leaf {name}: checkpoint {meta['dtype']}{list(arr.shape)} "
                f"!= expected {want_dtype}{list(want_shape)}"
            )
        if is_tensor:
            t = torch.from_numpy(arr)
            if want_dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            out.append(t.to(like.device))
        elif want_dtype == "bool":
            out.append(bool(arr))
        else:
            out.append(int(arr))
    return _unflatten(template, iter(out)), int(manifest["step"])


# --------------------------------------------------------------------------
# the chunked loop
# --------------------------------------------------------------------------


def _restore_or_fresh(ckpt_dir, template, tracer, metrics):
    """Latest durable snapshot, or the fresh state when none loads."""
    path = latest_checkpoint(ckpt_dir) if ckpt_dir else None
    if path is None:
        return template, 0
    try:
        with maybe_span(tracer, "faults.checkpoint_restore", cat="faults",
                        path=path):
            state, done = restore_checkpoint(path, template)
        if metrics is not None:
            metrics.counter("faults.checkpoint.restored").inc()
        return state, done
    except Exception:
        # Degrade, don't die: a corrupt snapshot must not be worse than
        # having no snapshot at all.
        if metrics is not None:
            metrics.counter("faults.checkpoint.restore_failed").inc()
        return template, 0


def checkpointed_compute(
    hg,
    max_iters: int,
    initial_msg,
    v_program,
    he_program,
    *,
    every: int,
    ckpt_dir: str | None = None,
    return_stats: bool = False,
    n_real=None,
    delivery=None,
    tracer=None,
    metrics=None,
    fault_injector=None,
    counters: dict | None = None,
):
    """``engine.compute`` in checkpointed chunks of ``every`` superstep
    pairs; resumes from ``ckpt_dir``'s latest snapshot when one exists.

    Same contract as ``compute``: returns the updated hypergraph (plus
    the full-length ``(v_trace, he_trace)`` when ``return_stats``).
    ``counters`` accumulates ``compute_resumable``'s ``pairs_run`` and
    ``host_syncs`` over the pairs run here, plus ``halted`` and
    ``resumed_from`` (the pairs the restored snapshot had done)."""
    counters = counters if counters is not None else {}
    for key in ("pairs_run", "host_syncs"):
        counters.setdefault(key, 0)
    zeros = torch.zeros(max_iters, dtype=torch.int32, device=hg.device)
    template = {**initial_superstep_state(hg, initial_msg),
                "v_trace": zeros, "he_trace": zeros.clone()}
    state, done = _restore_or_fresh(ckpt_dir, template, tracer, metrics)
    counters["resumed_from"] = done
    while done < max_iters and not state["halted"]:
        k = min(every, max_iters - done)
        carry, tr = compute_resumable(
            hg, k, state, v_program, he_program,
            n_real=n_real, delivery=delivery, counters=counters,
        )
        state = {**state, **carry}
        state["v_trace"][done:done + k] = tr[0]
        state["he_trace"][done:done + k] = tr[1]
        done += k
        if ckpt_dir:
            with maybe_span(tracer, "faults.checkpoint_save", cat="faults",
                            step=done):
                save_checkpoint(ckpt_dir, done, state)
            if metrics is not None:
                metrics.counter("faults.checkpoint.saved").inc()
        if fault_injector is not None:
            fault_injector.maybe_raise("checkpoint.chunk", step=done)
    counters["halted"] = bool(state["halted"])
    out = hg.with_attrs(v_attr=state["v_attr"], he_attr=state["he_attr"])
    if return_stats:
        # Rows past a halt stay 0: the full-length trace ``compute``
        # returns (the JAX package's ``_finish_traces`` pads to it).
        return out, (state["v_trace"], state["he_trace"])
    return out


def checkpointed_distributed_compute(
    hg,
    plan,
    mesh,
    max_iters: int,
    initial_msg,
    v_program,
    he_program,
    *,
    every: int,
    ckpt_dir: str | None = None,
    axis: str = "data",
    backend: str = "replicated",
    delivery: str = "xla",
    return_stats: bool = False,
    shard=None,
    tracer=None,
    metrics=None,
    fault_injector=None,
    counters: dict | None = None,
):
    """``distributed_compute`` in checkpointed chunks — the distributed
    twin of ``checkpointed_compute``, called by every rank.

    One snapshot covers the full padded state and the trace of the pairs
    done, so a run restarted on the same plan resumes bitwise where the
    last snapshot left it.  ``shard``: this rank's ``plan_rank_shard``,
    which every chunk reads (built here once when ``None``).
    ``counters`` as ``checkpointed_compute``'s."""
    import torch.distributed as dist

    from repro_torch.core.distributed import (
        DistContext,
        distributed_compute_resumable,
        distributed_initial_state,
        plan_rank_shard,
    )

    counters = counters if counters is not None else {}
    for key in ("pairs_run", "host_syncs"):
        counters.setdefault(key, 0)
    if shard is None:
        ctx = DistContext.for_mesh(mesh, axis, hg.n_vertices,
                                   hg.n_hyperedges, backend)
        shard = plan_rank_shard(hg, plan, ctx, delivery)
    group = mesh.get_group(axis)
    rank = dist.get_rank(group)
    zeros = torch.zeros(max_iters, dtype=torch.int32, device=hg.device)
    template = {**distributed_initial_state(hg, plan, initial_msg),
                "v_trace": zeros, "he_trace": zeros.clone()}
    state, done = _restore_or_fresh(ckpt_dir, template, tracer, metrics)
    counters["resumed_from"] = done
    while done < max_iters and not state["halted"]:
        k = min(every, max_iters - done)
        carry, tr = distributed_compute_resumable(
            hg, plan, mesh, k, state, v_program, he_program, axis=axis,
            backend=backend, delivery=delivery, shard=shard,
            counters=counters,
        )
        state = {**state, **carry}
        state["v_trace"][done:done + k] = tr[0]
        state["he_trace"][done:done + k] = tr[1]
        done += k
        if ckpt_dir:
            if rank == 0:
                with maybe_span(tracer, "faults.checkpoint_save",
                                cat="faults", step=done):
                    save_checkpoint(ckpt_dir, done, state)
                if metrics is not None:
                    metrics.counter("faults.checkpoint.saved").inc()
            dist.barrier(group=group)
        if fault_injector is not None:
            fault_injector.maybe_raise("checkpoint.chunk", step=done)
    counters["halted"] = bool(state["halted"])
    out = hg.with_attrs(
        v_attr=tree_map(lambda x: x[:hg.n_vertices], state["v_attr"]),
        he_attr=tree_map(lambda x: x[:hg.n_hyperedges], state["he_attr"]),
    )
    if return_stats:
        return out, (state["v_trace"], state["he_trace"])
    return out
