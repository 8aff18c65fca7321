"""Parameter trees of the GNN and recsys models: nested dicts and lists
of float32 tensors in the JAX package's structure (``train.tree`` walks
them in ``jax.tree.leaves``' order), drawn from a torch generator or
carried over from the JAX package's numpy leaves."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.layers import _normal


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Float32 normal draws times ``scale`` on ``gen``'s device."""
    return _normal(gen, shape, scale, torch.float32)


def tree_from_jax(tree, device=None):
    """The JAX package's parameter pytree (its leaves as numpy arrays,
    ``jax.tree.map(np.asarray, params)``) as the same dicts and lists
    of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)
