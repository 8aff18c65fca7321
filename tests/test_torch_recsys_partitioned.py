"""BERT4Rec's cells partitioned over a ``(data, model)`` mesh by DTensor
placements (``launch.tasks.build_recsys_task`` on a ``DeviceMesh``), on
four ``gloo`` ranks, held against the JAX package on the CPU.

One spawn (``launch.mesh.spawn_ranks``, a 180 s deadline) runs every
case of ``tests/torch_recsys_ranks.py`` (which imports no JAX) on (data
2, model 2) and (data 1, model 4), at ``bert4rec-smoke`` (vocab 1,024,
d 16, S 16).  Weights are drawn with numpy in the JAX package's shapes
and carried into both packages (``params_from_jax``); batches and
candidates come from numpy.  This process computes the JAX package's
answers first and pickles the inputs.

Held, at ``tests/test_torch_lm_partitioned.py``'s limits: the train
step (B 8, 4 masked positions, 64 shared negatives) against the JAX
package's ``make_train_step`` on ``loss_sampled`` (loss rtol 1e-5,
``grad_norm`` rtol 1e-4, each first moment within 1e-4 of its largest
magnitude, each parameter within 2 ``lr`` + 1e-6), the table and its
moments over ``model``; serving (B 8) and retrieval (1,000 candidates):
the top-100 scores within 1e-5 of the largest magnitude, and the ids
``jax.lax.top_k``'s, or, where two scores lie within 1e-5, ids whose
reference scores are the ones the reference ranks there.
``_embed_partitioned`` with ids cut over every axis equals
``take_rows``, rows bitwise.  A checkpoint written on (2, 2) and
restored on (1, 4) takes one more step equal to the straight run's
second.  Each planted fault (the table's gradient left unreduced over
``data``; each ``model`` rank's candidate ids looked up in its own shard
alone) misses the reference.
"""
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.recsys.bert4rec as jb
import repro.train as jtrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.recsys import bert4rec as tb
from repro_torch.sparse.gather import take_rows
from repro_torch.train.tree import named_leaves

sys.path.insert(0, os.path.dirname(__file__))
import torch_recsys_ranks as ranks  # noqa: E402
from test_torch_lm_partitioned import (F32_REL, GNORM_RTOL,  # noqa: E402
                                       GRAD_REL, LOSS_RTOL, _hold_step,
                                       _rel)

WORLD = 4
TOP_K = 100
MESHES = sorted(ranks.MESHES)


def _jc():
    return jcfg.get_config(ranks.ARCH, True).model


def _np_params(jc):
    """Weights in the JAX package's pytree, drawn with numpy: the
    reference's scales for the products, ones and small draws for the
    layer norms and biases."""
    shapes = jax.eval_shape(lambda k: jb.init_params(k, jc),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        if len(leaf.shape) == 1:
            return (0.02 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        fan = leaf.shape[-1] if "embed" in name else leaf.shape[-2]
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(jc, seed):
    """Left-padded sequences (PAD = 0), ``MASKED`` distinct positions a
    row set to MASK (their items the labels), shared negatives."""
    rng = np.random.default_rng(seed)
    s = jc.max_seq
    items = rng.integers(1, jc.n_items + 1, (ranks.B, s)).astype(np.int32)
    for i in range(ranks.B):
        items[i, :rng.integers(0, s // 3)] = 0
    pos = np.stack([rng.choice(np.arange(s // 3, s), ranks.MASKED,
                               replace=False) for _ in range(ranks.B)])
    pos = pos.astype(np.int32)
    labels = np.take_along_axis(items, pos, axis=1)
    np.put_along_axis(items, pos, jc.mask_id, axis=1)
    return {"items": items, "masked_pos": pos, "labels": labels,
            "negatives": rng.integers(1, jc.n_items + 1, ranks.NEG).astype(
                np.int32)}


def _reference(jc, params, batch, cand):
    """The JAX package's train step, serving scores and top-100, and
    retrieval scores and top-100."""
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jtrain.make_train_step(
        lambda p, b: jb.loss_sampled(p, jc, b), jtrain.AdamWConfig()))
    new, m = step(jtrain.init_train_state(jp),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    items = jnp.asarray(batch["items"])
    scores = jax.jit(lambda p, x: jb.serve_score(p, jc, x))(jp, items)
    vals, ids = jax.lax.top_k(scores, TOP_K)
    r_scores = jax.jit(lambda p, x, c: jb.retrieval_score(p, jc, x, c))(
        jp, items[:1], jnp.asarray(cand))
    r_vals, r_ids = jax.lax.top_k(r_scores, TOP_K)
    return {"state": jax.tree.map(np.asarray, new),
            "metrics": {k: float(v) for k, v in m.items()},
            "serve": (np.asarray(scores), np.asarray(vals), np.asarray(ids)),
            "retrieval": (np.asarray(r_scores), np.asarray(r_vals),
                          np.asarray(r_ids))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference answers, the inputs, the ranks' results)``."""
    out_dir = str(tmp_path_factory.mktemp("recsys_ranks"))
    jc = _jc()
    params = _np_params(jc)
    batch = _batch(jc, 1)
    cand = np.random.default_rng(3).integers(
        1, jc.n_items + 1, ranks.CAND).astype(np.int32)
    ref = _reference(jc, params, batch, cand)
    inputs = {"params": params, "batch": batch, "batch2": _batch(jc, 2),
              "cand": cand,
              **ranks.lookup_inputs(jc.vocab, jc.embed_dim, 4)}
    in_path = os.path.join(out_dir, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    spawn_ranks(ranks.run_cases, WORLD,
                (os.path.join(out_dir, "store"), in_path, out_dir),
                deadline_s=180.0)
    with open(os.path.join(out_dir, "recsys_ranks.pkl"), "rb") as f:
        return ref, inputs, pickle.load(f)


def _port_leaves(tree) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's named leaves."""
    return {name: leaf.detach().numpy() for name, leaf in named_leaves(
        tb.params_from_jax(tree, device="cpu"))}


def _hold_top_k(got, ref_scores, ref_vals, ref_ids):
    """Scores within ``F32_REL`` of the largest magnitude; each id the
    reference's, or, where the reference's scores at that rank and the
    next (or the one before) lie within ``F32_REL``, an id whose
    reference score is the one ranked there."""
    vals, ids = np.asarray(got["vals"]), np.asarray(got["ids"])
    assert vals.shape == ref_vals.shape and ids.shape == ref_ids.shape
    assert _rel(vals, ref_vals) <= F32_REL
    tol = F32_REL * float(np.abs(ref_scores).max())
    rows = ref_scores.reshape(-1, ref_scores.shape[-1])
    for r, (g, w, wv) in enumerate(zip(ids.reshape(-1, TOP_K),
                                       ref_ids.reshape(-1, TOP_K),
                                       ref_vals.reshape(-1, TOP_K))):
        for j in np.flatnonzero(g != w):
            near = np.abs(wv - wv[j]) <= tol
            near[j] = False
            assert near.any(), (r, j, g[j], w[j])
            assert abs(rows[r, g[j]] - wv[j]) <= tol, (r, j)
        assert len(set(g.tolist())) == TOP_K


@pytest.mark.parametrize("mesh", MESHES)
def test_partitioned_recsys_train_step_matches_the_reference(runs, mesh):
    ref, _, got = runs
    _hold_step(got["train"][mesh], ref["metrics"], ref["state"], ranks.ARCH,
               port_leaves=_port_leaves)


@pytest.mark.parametrize("mesh", MESHES)
def test_partitioned_recsys_state_keeps_the_table_over_model(runs, mesh):
    """The table and its moments stay cut over ``model`` (4 or 2 ways),
    every other leaf replicated: no rank holds the whole table."""
    _, _, got = runs
    model = "Shard(dim=0)"
    data = "Replicate()"
    for name, pl in got["train"][mesh]["placed"].items():
        want = (f"({data}, {model})" if "item_embed" in name
                else "(Replicate(), Replicate())")
        assert pl == want, (name, pl)


@pytest.mark.parametrize("mesh", MESHES)
def test_partitioned_recsys_serve_top_k_matches_the_reference(runs, mesh):
    """Each device's own rows' top-100 (rows over every axis)."""
    ref, _, got = runs
    g = got["serve"][mesh]
    assert g["placements"] == {"2x2": "(Shard(dim=0), Shard(dim=0))",
                               "1x4": "(Replicate(), Shard(dim=0))"}[mesh]
    _hold_top_k(g, *ref["serve"])


@pytest.mark.parametrize("mesh", MESHES)
def test_partitioned_recsys_retrieval_matches_the_reference(runs, mesh):
    """The candidates over every axis, the table over ``model``; one
    top-100 over the whole list, replicated."""
    ref, _, got = runs
    g = got["retrieval"][mesh]
    assert g["placements"] == "(Replicate(), Replicate())"
    _hold_top_k(g, *ref["retrieval"])


@pytest.mark.parametrize("mesh", MESHES)
def test_embed_partitioned_takes_ids_over_the_vocab_axis(runs, mesh):
    """Ids cut over every axis, ``model`` among them (which cuts the
    table's rows): rows bitwise ``take_rows``', laid out as the ids, and
    the table's gradient ``take_rows``'."""
    _, inputs, got = runs
    g = got["lookup"][mesh]
    table = torch.from_numpy(inputs["params"]["item_embed"]).requires_grad_()
    rows = take_rows(table, torch.from_numpy(inputs["lookup_ids"]))
    (rows * torch.from_numpy(inputs["lookup_weights"])).sum().backward()
    np.testing.assert_array_equal(g["rows"], rows.detach().numpy())
    assert g["placements"] == {"2x2": "(Shard(dim=0), Shard(dim=0))",
                               "1x4": "(Replicate(), Shard(dim=0))"}[mesh]
    np.testing.assert_allclose(g["grad"], table.grad.numpy(), rtol=0,
                               atol=1e-6)


def test_recsys_checkpoint_on_2x2_resumes_on_1x4_as_the_straight_run(runs):
    _, _, got = runs
    c = got["checkpoint"]
    assert c["step"] == 1
    assert c["placed"][".params/['item_embed']"] == (
        "(Replicate(), Shard(dim=0))")
    assert c["placed"][".opt_state/['nu']/['item_embed']"] == (
        "(Replicate(), Shard(dim=0))")
    s, r = c["straight"], c["resumed"]
    np.testing.assert_allclose(r["loss"], s["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["grad_norm"], s["grad_norm"],
                               rtol=GNORM_RTOL)
    atol = 2 * s["lr"] + 1e-6
    for name, w in s["leaves"].items():
        np.testing.assert_allclose(r["leaves"][name], w, rtol=0, atol=atol,
                                   err_msg=name)


def test_planted_unreduced_table_gradient_misses_the_reference(runs):
    """Each data rank updating the table with its own rows' gradient
    alone: the forward's loss is the reference's, the table's first
    moment and ``grad_norm`` are not; the partitioned step meets
    both."""
    ref, _, got = runs
    bad = got["faults"]["unreduced_table_grad"]
    want_mu = _port_leaves(ref["state"].opt_state["mu"])["['item_embed']"]
    name = ".opt_state/['mu']/['item_embed']"
    assert _rel(bad["leaves"][name], want_mu) > GRAD_REL
    want = ref["metrics"]["grad_norm"]
    assert abs(bad["grad_norm"] - want) > GNORM_RTOL * want
    assert _rel(got["train"]["2x2"]["leaves"][name], want_mu) <= GRAD_REL


def test_planted_own_shard_retrieval_misses_the_reference(runs):
    """Each ``model`` rank looking its own candidate ids up in its own
    table shard alone scores most candidates against a zero row."""
    ref, _, got = runs
    bad = got["faults"]["own_shard_retrieval"]
    assert _rel(bad["vals"], ref["retrieval"][1]) > F32_REL
    assert not np.array_equal(bad["ids"], ref["retrieval"][2])
