"""The edge-sharded GNN step (``launch.gnn_sharded``) on four ``gloo``
ranks against the plain step, on the CPU.

One spawn (``launch.mesh.spawn_ranks``, a 180 s deadline) runs every
case of ``tests/torch_gnn_ranks.py``: gat-cora, NequIP and MACE at their
``smoke()`` widths, as the JAX package's ``tests/test_gnn_sharded.py``
holds them, plus PNA for the max / min merges.  Each rank keeps a
contiguous quarter of the 80 edges; rank 0 pickles its results.  This
process runs ``train.make_train_step`` on the same graph and weights.
Held, with the reference test's ``AdamWConfig()``: the loss and every
parameter within 5e-4 (the reference's bound); and, since a first step
of AdamW moves each weight by about ``lr`` (3e-6 in warmup) whatever
the gradient, the first moments (the clipped gradients) and
``grad_norm`` within 1e-4 of their largest magnitudes.
"""
import os
import pickle
import sys

import numpy as np
import pytest

from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train import make_train_step

sys.path.insert(0, os.path.dirname(__file__))
import torch_gnn_ranks as ranks  # noqa: E402

WORLD = 4
TOL = 5e-4
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("gnn_ranks"))
    spawn_ranks(ranks.run_cases, WORLD,
                (os.path.join(out_dir, "store"), out_dir), deadline_s=180.0)
    with open(os.path.join(out_dir, "gnn_ranks.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch", list(ranks.CASES))
def test_edge_sharded_step_matches_plain(sharded, arch):
    mod, cfg, g, state = ranks.case_inputs(arch)
    step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b), ranks.OPT)
    want = ranks.result(*step(state, g))
    got = sharded[arch]
    assert abs(got["loss"] - want["loss"]) < TOL
    for a, b in zip(got["params"], want["params"]):
        assert np.abs(a - b).max() < TOL
    assert abs(got["grad_norm"] - want["grad_norm"]) <= GRAD_REL * max(
        want["grad_norm"], 1e-30)
    scale = max(np.abs(m).max() for m in want["mu"])
    for a, b in zip(got["mu"], want["mu"]):
        assert np.abs(a - b).max() <= GRAD_REL * max(np.abs(b).max(),
                                                     1e-7 * scale)
