"""Checkpoint / restore of a training state, the counterpart of the JAX
package's ``repro.train.checkpoint``, with its on-disk contract:

* a checkpoint is the whole training tree (parameters, moments, step)
  written leaf by leaf as ``leaf_%05d.npy`` inside ``step_%08d``, plus a
  ``manifest.json`` with ``step`` and ``leaves[{name, file, shape, dtype,
  sha256_16}]`` (the first 16 hex digits of each leaf's sha256: a
  corrupt leaf is found on restore);
* writes are atomic: into ``<dir>.tmp``, then ``rename``, so a killed
  process never leaves a checkpoint that restore would trust;
* ``latest_checkpoint`` finds the highest complete step.

Leaves are named and ordered as ``train.tree`` walks the tree (the
JAX package's key-path names, a dict's and a ``ParamTree``'s keys in
sorted order).  ``device=`` places the restored leaves (by default where
the template's are).  The leaves are copied to the host to be written:
the one host read of a training run besides its printed metrics.

A partitioned state (DTensor leaves) is written in the same format, as
whole leaves, one at a time: every rank gathers a leaf
(``full_tensor``), rank 0 writes it and the others drop it, and the
ranks meet at a barrier, so the JAX package's
``restore_checkpoint`` reads it.  ``restore_checkpoint(..., mesh=,
placements=)`` is the counterpart of the JAX package's ``shardings=``:
each leaf is placed on ``mesh`` under its placements (``launch.tasks``'
``{leaf name: placements}``), whatever mesh shape wrote it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.sharding import distribute, is_dtensor
from repro_torch.train.tree import leaves, named_leaves, path_str, unflatten


def _whole(leaf):
    """A DTensor leaf gathered whole (every rank of its mesh calls it),
    else the leaf itself."""
    return leaf.full_tensor() if is_dtensor(leaf) else leaf


def _host(leaf) -> np.ndarray:
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no .npy type")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Atomically persist ``tree`` for ``step``; returns the final path.
    With DTensor leaves every rank of their mesh calls it: each leaf is
    gathered in turn, rank 0 writes it and the other ranks drop it, so
    a rank holds one whole leaf at a time."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    named = named_leaves(tree)
    if any(is_dtensor(leaf) for _, leaf in named):
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(final, step, ((name, _host(leaf)) for name, leaf in named))
        else:
            for _, leaf in named:
                _whole(leaf)  # the gather is a collective: dropped here
        dist.barrier()
        return final
    return _write(final, step, ((name, _host(leaf)) for name, leaf in named))


def _write(final: str, step: int, arrays) -> str:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr) in enumerate(arrays):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        manifest["leaves"].append({
            "name": name,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256_16": digest,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_checkpoint(ckpt_dir: str) -> str | None:
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


def restore_checkpoint(path: str, tree_like, *, device=None,
                       verify: bool = True, mesh=None, placements=None):
    """Restore into the structure of ``tree_like``: ``(tree, step)``.
    Each leaf lands on ``device``, or where ``tree_like``'s leaf is (for
    a DTensor leaf, on its mesh's device).  With ``mesh`` and
    ``placements`` (``{leaf name 'a/b/c': placements}``), each leaf is a
    DTensor on ``mesh`` under its placements.  Raises ``IOError`` on a
    hash mismatch (with ``verify``) and ``ValueError`` on a leaf count
    or a shape that differs."""
    if (mesh is None) != (placements is None):
        raise ValueError("pass mesh= and placements= together")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names_leaves = named_leaves(tree_like)
    if len(names_leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"expected {len(names_leaves)}"
        )
    out = []
    for (name, like), meta in zip(names_leaves, manifest["leaves"]):
        arr = np.load(os.path.join(path, meta["file"]))
        if verify:
            digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
            if digest != meta["sha256_16"]:
                raise IOError(
                    f"checkpoint leaf {meta['name']} corrupt "
                    f"(hash mismatch)"
                )
        if list(arr.shape) != list(np.shape(like)):
            raise ValueError(
                f"leaf {meta['name']}: checkpoint shape {arr.shape} != "
                f"expected {tuple(np.shape(like))}"
            )
        if mesh is not None:
            dev = device if device is not None else (
                torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else torch.device("cpu"))
            out.append(distribute(torch.from_numpy(arr).to(dev), mesh,
                                  placements[path_str(name)]))
        elif isinstance(like, torch.Tensor):
            if device is None and is_dtensor(like):
                device = like.to_local().device
            out.append(torch.from_numpy(arr).to(
                like.device if device is None else device))
        else:
            out.append(arr)
    tree = unflatten(tree_like, out)
    for new, old in zip(leaves(tree), leaves(tree_like)):
        if isinstance(old, torch.Tensor) and old.requires_grad:
            new.requires_grad_(True)
    return tree, manifest["step"]
