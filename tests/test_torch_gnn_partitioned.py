"""The GNN ``pjit`` cells partitioned over a ``(data, model)`` mesh by
DTensor placements (``launch.tasks.build_gnn_task`` on a
``DeviceMesh``), on four ``gloo`` ranks, held against the JAX package on
the CPU.

One spawn (``launch.mesh.spawn_ranks``, a 300 s deadline) runs every
case of ``tests/torch_gnn_pjit_ranks.py`` (which imports no JAX) on
(data 2, model 2) and (data 1, model 4), at the four ``smoke()``
configs: gat-cora on ``random_graph(24, 80)``; PNA and NequIP on it and
on a batch of 4 molecules (32 nodes, 96 edges: the per-graph
readouts); MACE on the molecules.  The graphs are the JAX package's
``random_graph`` draws, the weights its ``init_params``' carried into
the port by each module's ``params_from_jax``, the molecules' energy
targets drawn with numpy.  This process computes the JAX package's
answers first and pickles the inputs.

Held, at ``tests/test_torch_lm_partitioned.py``'s limits: ``Task.run``'s
step and a second step from its state against two steps of the JAX
package's ``make_train_step`` on ``loss_fn`` over the whole graph: loss
rtol 1e-5, ``grad_norm`` rtol 1e-4, ``lr`` rtol 1e-6, each moment
within 1e-4 of its largest magnitude (floored at 1e-7 of the whole
moment's: a gradient that vanishes by symmetry, a MACE CG path, is
float noise in both packages, as ``tests/test_torch_gnn.py`` floors it),
each parameter within 2 ``lr`` + 1e-6; the state replicated.  One
``gather_nodes`` takes one all-gather forward and one reduce-scatter
backward, one ``mp_segment_sum`` one reduce-scatter forward and one
all-gather backward, each with the plain op's values and gradient.
Each planted fault (a segment sum's partial left unreduced over
``model``; the node gather indexing the rank's own node shard) misses
the reference's loss.
"""
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.gnn as jgnn
import repro.train as jtrain
from repro.models.gnn import equivariant as jeq
from repro.models.gnn import gat as jgat
from repro.models.gnn import pna as jpna
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.train.tree import named_leaves

sys.path.insert(0, os.path.dirname(__file__))
import torch_gnn_pjit_ranks as ranks  # noqa: E402
from test_torch_lm_partitioned import (GNORM_RTOL, GRAD_REL,  # noqa: E402
                                       LOSS_RTOL)

WORLD = 4
MESHES = sorted(ranks.MESHES)
JAX_MODULES = {"gat-cora": jgat, "pna": jpna, "nequip": jeq, "mace": jeq}
# a moment's scale is floored at this share of the whole moment's
FLOOR_SHARE = 1e-7
FIELDS = ("edge_src", "edge_dst", "edge_mask", "node_feat", "positions",
          "species", "node_mask", "graph_ids", "labels")


def _jax_graph(arch, kind):
    """The JAX package's graph of a case (the same seed for every
    case): node features for GAT / PNA, positions, species and numpy
    energy targets for the equivariant models."""
    cfg = jcfg.get_config(arch, True).model
    size = ranks.GRAPHS[kind]
    n, e, b = size["n_nodes"], size["n_edges"], size["n_graphs"]
    if arch in ("nequip", "mace"):
        g = jgnn.random_graph(n, e, with_positions=True,
                              n_species=cfg.n_species, n_graphs=b, seed=3)
        energy = np.random.default_rng(5).standard_normal(b)
        return dataclasses.replace(g, labels=jnp.asarray(energy,
                                                         jnp.float32))
    return jgnn.random_graph(n, e, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                             n_graphs=b, seed=3)


def _graph_arrays(g) -> dict:
    out = {f: None if getattr(g, f) is None else np.asarray(getattr(g, f))
           for f in FIELDS}
    return {**out, "n_nodes": int(g.n_nodes), "n_graphs": int(g.n_graphs)}


def _reference(arch, kind, params, g):
    """Two steps of the JAX package's train step over the whole graph:
    ``(metrics, state)`` after each."""
    jm = JAX_MODULES[arch]
    cfg = jcfg.get_config(arch, True).model
    step = jax.jit(jtrain.make_train_step(
        lambda p, b: jm.loss_fn(p, cfg, b), jtrain.AdamWConfig()))
    state = jtrain.init_train_state(jax.tree.map(jnp.asarray, params))
    out = []
    for _ in range(2):
        state, m = step(state, g)
        out.append(({k: float(v) for k, v in m.items()},
                    jax.tree.map(np.asarray, state)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference answers by case, the inputs, the ranks' results)``."""
    out_dir = str(tmp_path_factory.mktemp("gnn_pjit_ranks"))
    params, graphs, refs = {}, {}, {}
    for arch, kind in ranks.CASES:
        cfg = jcfg.get_config(arch, True).model
        jm = JAX_MODULES[arch]
        p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
        g = _jax_graph(arch, kind)
        params[arch, kind] = p
        refs[arch, kind] = _reference(arch, kind, p, g)
        graphs[arch, kind] = _graph_arrays(g)
    inputs = {"params": params, "graphs": graphs,
              "collectives": ranks.collectives_inputs(7)}
    in_path = os.path.join(out_dir, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    spawn_ranks(ranks.run_cases, WORLD,
                (os.path.join(out_dir, "store"), in_path, out_dir),
                deadline_s=300.0)
    with open(os.path.join(out_dir, "gnn_pjit_ranks.pkl"), "rb") as f:
        return refs, inputs, pickle.load(f)


def _port_leaves(arch, tree) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's named leaves."""
    import repro_torch.configs as tcfg

    cfg = tcfg.get_config(arch, True).model
    return {name: leaf.detach().numpy() for name, leaf in named_leaves(
        ranks.MODULES[arch].params_from_jax(tree, cfg, device="cpu"))}


def _hold_step(got, ref, arch, step):
    """One step's metrics, both moments and the parameters against the
    reference's (the module docstring's limits)."""
    metrics, state = ref
    np.testing.assert_allclose(got["loss"], metrics["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], metrics["grad_norm"],
                               rtol=GNORM_RTOL)
    np.testing.assert_allclose(got["lr"], metrics["lr"], rtol=1e-6)
    leaves = got["leaves"]
    for moment in ("mu", "nu"):
        want = _port_leaves(arch, state.opt_state[moment])
        scale = max(float(np.abs(w).max()) for w in want.values())
        for name, w in want.items():
            have = leaves[f".opt_state/['{moment}']/{name}"]
            den = max(float(np.abs(w).max()), FLOOR_SHARE * scale, 1e-30)
            assert np.abs(have - w).max() <= GRAD_REL * den, (moment, name)
    atol = 2 * metrics["lr"] + 1e-6
    for name, w in _port_leaves(arch, state.params).items():
        np.testing.assert_allclose(leaves[f".params/{name}"], w, rtol=0,
                                   atol=atol, err_msg=name)
    assert int(leaves[".opt_state/['step']"]) == step


@pytest.mark.parametrize("step", [1, 2])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,kind", ranks.CASES)
def test_partitioned_gnn_step_matches_the_reference(runs, arch, kind, mesh,
                                                    step):
    refs, _, got = runs
    _hold_step(got["train"][arch, kind, mesh][f"step{step}"],
               refs[arch, kind][step - 1], arch, step)


@pytest.mark.parametrize("mesh", MESHES)
def test_partitioned_gnn_state_stays_replicated(runs, mesh):
    """The parameters and moments of every case come out replicated:
    their gradients summed over every rank's own edges and nodes."""
    _, _, got = runs
    whole = "(Replicate(), Replicate())"
    for arch, kind in ranks.CASES:
        placed = got["train"][arch, kind, mesh]["step1"]["placed"]
        assert set(placed.values()) == {whole}, (arch, kind)


_ROWS = {"2x2": "(Shard(dim=0), Shard(dim=0))",
         "1x4": "(Replicate(), Shard(dim=0))"}


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_nodes_takes_one_all_gather_and_one_reduce_scatter(runs,
                                                                  mesh):
    """Node rows over both axes picked by edge ids over both axes: one
    all-gather of the rows forward, one reduce-scatter of their
    cotangent backward (one collective over the flattened axes, not one
    a mesh dim); the rows bitwise ``x[ids]``, the gradient the plain
    one's."""
    _, inputs, got = runs
    c, g = inputs["collectives"], got["collectives"][mesh]["gather"]
    assert g["forward"] == {"all_gather_into_tensor": 1}
    assert g["backward"] == {"reduce_scatter_tensor": 1}
    assert g["placements"] == _ROWS[mesh]
    x = torch.from_numpy(c["nodes"]).requires_grad_()
    rows = x[torch.from_numpy(c["ids"])]
    rows.backward(torch.from_numpy(c["gather_weights"]))
    np.testing.assert_array_equal(g["value"], rows.detach().numpy())
    np.testing.assert_allclose(g["grad"], x.grad.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_segment_sum_takes_one_reduce_scatter_and_one_all_gather(runs,
                                                                 mesh):
    """Edge rows summed into node rows over both axes: the rank's partial
    reduce-scattered once forward, the cotangent all-gathered once
    backward; the sums the plain ``mp_segment_sum``'s, the gradient
    bitwise its gather."""
    from repro_torch.sparse.segment import mp_segment_sum

    _, inputs, got = runs
    c, g = inputs["collectives"], got["collectives"][mesh]["segment_sum"]
    assert g["forward"] == {"reduce_scatter_tensor": 1}
    assert g["backward"] == {"all_gather_into_tensor": 1}
    assert g["placements"] == _ROWS[mesh]
    x = torch.from_numpy(c["messages"]).requires_grad_()
    sums = mp_segment_sum(x, torch.from_numpy(c["ids"]), c["n_nodes"])
    sums.backward(torch.from_numpy(c["segment_sum_weights"]))
    np.testing.assert_allclose(g["value"], sums.detach().numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(g["grad"], x.grad.numpy())


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_nodes_refuses_an_uneven_cut(runs, mesh):
    """22 node rows over 4 ranks: ``gather_nodes`` raises (the task pads
    N and E to the device count) rather than index rows a rank lacks."""
    _, _, got = runs
    assert "do not divide evenly over 4 ranks" in got["collectives"][mesh][
        "uneven"]


@pytest.mark.parametrize("fault", ["unreduced_over_model", "own_node_shard"])
def test_planted_fault_misses_the_reference(runs, fault):
    """gat-cora's step on (2, 2) with a segment sum's partial left
    unreduced over ``model``, or with the node gather indexing the
    rank's own node shard: its loss misses the reference's, which the
    partitioned step meets."""
    refs, _, got = runs
    case = ranks.FAULT_CASE
    want = refs[case][0][0]["loss"]
    bad = got["faults"][fault]["step1"]["loss"]
    # (a NaN loss misses too)
    assert not np.isclose(bad, want, rtol=LOSS_RTOL, atol=0), (bad, want)
    good = got["train"][case + ("2x2",)]["step1"]["loss"]
    assert abs(good - want) <= LOSS_RTOL * abs(want)
