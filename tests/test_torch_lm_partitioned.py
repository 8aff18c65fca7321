"""The dense LM partitioned over a ``(data, model)`` mesh by DTensor
placements (``launch.tasks``' partitioned cells, ``models.sharding``),
on four ``gloo`` ranks, held against the JAX package on the CPU.

One spawn (``launch.mesh.spawn_ranks``, a 180 s deadline) runs every
case of ``tests/torch_lm_ranks.py`` (which imports no JAX) on two
meshes: (data 2, model 2), and (data 1, model 4), where the 2 KV heads
of each config and command-r-plus-104b's 6 query heads do not divide
``model`` and fall back to replicated.  Configs: llama3.2-1b,
command-r-plus-104b (the parallel block) and gemma3-12b (local layers)
at ``smoke()`` widths, float32 compute.  Weights are drawn with numpy in
the JAX package's ``init_params`` shapes and carried into both packages
(``params_from_jax``); tokens come from numpy.  This process computes
the JAX package's answers first (the decode cases start from its
prefill's cache) and pickles the inputs.

Held, at ``tests/test_torch_lm_train.py``'s tolerances: the train step
(2 micro-batches) against the JAX package's ``make_train_step`` (loss
rtol 1e-5, ``grad_norm`` rtol 1e-4, ``lr`` rtol 1e-6, each first moment
within 1e-4 of its largest magnitude, each parameter within 2 ``lr`` +
1e-6); at ``tests/test_torch_models_lm.py``'s: the prefill's last
logits (1e-5 of the largest magnitude) and its bfloat16 cache (one
bfloat16 step, or 1e-5), and four greedy decode steps on a float32
cache (ids equal, logits 1e-5), and on (2, 2) the same for one
sequence, whose cache's sequence is cut over both axes (the long-context
layout), and that decode once more in bfloat16 compute on a bfloat16
cache, fed the float32 run's ids (``test_torch_models_lm.py``'s
bfloat16 rule: no further from the float32 answer than twice the JAX
package's own bfloat16 run, and within 5e-2 of that run).  llama3.2-1b's
train step on (2, 2) with a mask whose counts differ between groupings
of the rows is held as the unmasked one.  A checkpoint written on (2, 2) and
restored on (1, 4) takes one more step equal to the straight run's
second, and the JAX package's ``restore_checkpoint`` reads it.  The
planted fault (every rank handed every KV head) must miss the loss.
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
import repro.models.transformer as jt
import repro.train as jtrain
from repro_torch.launch.mesh import spawn_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_lm_ranks as ranks  # noqa: E402

WORLD = 4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GNORM_RTOL = 1e-4
F32_REL = 1e-5
BF16_STEP = 2.0 ** -7
BF16_REL = 5e-2
# rows keep their first k positions: two micro-batches of contiguous
# rows count 40 and 24 positions, a data rank's i-th rows 52 and 12
MASK_KEEP = (32, 8, 20, 4)
CASES = [(a, m) for a in ranks.ARCHS for m in ranks.MESHES]


def _jcfg(arch):
    return dataclasses.replace(jcfg.get_config(arch, True).model,
                               compute_dtype=jnp.float32)


def _np_params(arch):
    """The smoke weights in the JAX package's pytree, drawn with numpy
    in its scales (``tests/test_torch_lm_train.py``'s draw)."""
    jc = _jcfg(arch)
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jc),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if len(leaf.shape) == 1 or name.endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        fan = leaf.shape[-1] if name.endswith("['table']") else (
            leaf.shape[-2])
        return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (ranks.B, ranks.S)).astype(np.int32)


def _batch_j(toks):
    return {"tokens": jnp.asarray(toks),
            "labels": jnp.asarray(np.roll(toks, -1, axis=1))}


def _mask():
    keep = np.asarray(MASK_KEEP)[:, None]
    return (np.arange(ranks.S)[None, :] < keep).astype(np.float32)


def _reference(arch, params, toks):
    """The JAX package's train step (2 micro-batches), prefill and four
    greedy decode steps on a float32 cache warmed by the prefill; for
    ``ranks.LONG_ARCHS``, the prefill and decode of the first sequence
    alone too (``*1``), and in bfloat16 fed the float32 run's ids
    (``*16``); for llama3.2-1b, the train step with ``_mask()``."""
    jc = _jcfg(arch)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jtrain.make_train_step(
        lambda p, b: jt.loss_fn(p, jc, b), jtrain.AdamWConfig(),
        ranks.ACCUM))
    new, m = step(jtrain.init_train_state(jparams), _batch_j(toks))
    out = {"state": jax.tree.map(np.asarray, new),
           "metrics": {k: float(v) for k, v in m.items()}}
    if arch == "llama3.2-1b":
        new, m = step(jtrain.init_train_state(jparams),
                      {**_batch_j(toks), "mask": jnp.asarray(_mask())})
        out["masked"] = {"state": jax.tree.map(np.asarray, new),
                         "metrics": {k: float(v) for k, v in m.items()}}
    out.update(_serve_reference(jc, jparams, toks))
    if arch in ranks.LONG_ARCHS:
        out.update({f"{k}1": v for k, v in _serve_reference(
            jc, jparams, toks[:1]).items()})
        jc16 = dataclasses.replace(jc, compute_dtype=jnp.bfloat16)
        out.update({f"{k}16": v for k, v in _serve_reference(
            jc16, jparams, toks[:1], first=out["first1"],
            feed=out["ids1"]).items()})
    return out


def _serve_reference(jc, jparams, toks, first=None, feed=None):
    """The prefill and ``GEN`` decode steps on a cache in the compute
    type, from the prefill's greedy ids or ``first``, each step fed the
    last one's greedy ids or ``feed[i]`` before step ``i + 1``."""
    last, warm = jax.jit(lambda p, t: jt.prefill(p, jc, t))(
        jparams, jnp.asarray(toks))
    cache = jt.init_cache(jc, toks.shape[0], ranks.S + ranks.GEN,
                          dtype=jc.compute_dtype)
    cache = {k: jax.lax.dynamic_update_slice_in_dim(
        cache[k], warm[k].astype(jc.compute_dtype), 0, axis=2)
        for k in cache}
    serve = jax.jit(lambda p, c, t, pos: jt.serve_step(p, jc, c, t, pos))
    if first is None:
        first = np.asarray(jnp.argmax(last, axis=-1).astype(jnp.int32))
    tok = jnp.asarray(first)
    steps, ids = [], []
    for i in range(ranks.GEN):
        lg, cache = serve(jparams, cache, tok, jnp.int32(ranks.S + i))
        steps.append(np.asarray(lg.astype(jnp.float32)))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        ids.append(np.asarray(tok))
        if feed is not None:
            tok = jnp.asarray(feed[i])
    return {"last": np.asarray(last.astype(jnp.float32)),
            "warm": {k: np.asarray(v.astype(jnp.float32))
                     for k, v in warm.items()},
            "first": first, "steps": steps, "ids": ids}


def _split_kv_inputs():
    """One decode query against a 64-position cache (8 heads, 2 KV
    heads, width 32) of bfloat16 values, filled to 50: the last of the
    four ranks' 16-position shards holds none of it."""
    rng = np.random.default_rng(7)

    def bf16(shape):
        return np.asarray(jnp.asarray(rng.standard_normal(shape),
                                      jnp.bfloat16).astype(jnp.float32))

    return {"q": bf16((1, 1, 8, 32)), "k": bf16((1, 64, 2, 32)),
            "v": bf16((1, 64, 2, 32)), "cache_len": 50,
            "windows": (None, 24)}


def _split_kv_reference(inp):
    from repro.models.attention import decode_attention

    q, k, v = (jnp.asarray(inp[key], jnp.bfloat16) for key in ("q", "k",
                                                               "v"))
    return {w: np.asarray(decode_attention(
        q, k, v, inp["cache_len"], window=w).astype(jnp.float32))
        for w in inp["windows"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference answers, the ranks' results)``."""
    out_dir = str(tmp_path_factory.mktemp("lm_ranks"))
    inputs, refs = {}, {}
    for i, arch in enumerate(ranks.ARCHS):
        params = _np_params(arch)
        vocab = _jcfg(arch).vocab
        toks = _tokens(vocab, 10 + i)
        refs[arch] = _reference(arch, params, toks)
        inputs[arch] = {"params": params, "tokens": toks,
                        "tokens2": _tokens(vocab, 20 + i),
                        "mask": _mask(),
                        **{k: refs[arch][k] for k in (
                            "warm", "first", "warm1", "first1", "ids1",
                            "warm16") if k in refs[arch]}}
    inputs["split_kv"] = _split_kv_inputs()
    refs["split_kv"] = _split_kv_reference(inputs["split_kv"])
    in_path = os.path.join(out_dir, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    spawn_ranks(ranks.run_cases, WORLD,
                (os.path.join(out_dir, "store"), in_path, out_dir),
                deadline_s=180.0)
    with open(os.path.join(out_dir, "lm_ranks.pkl"), "rb") as f:
        return refs, inputs, pickle.load(f)


def _rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _port_leaves(tree, arch) -> dict:
    """A JAX parameter tree (numpy leaves) as the port's named leaves."""
    from repro_torch.models import transformer as tt
    from repro_torch.train.tree import named_leaves

    cfg = ranks.config(arch).model
    return {name: leaf.detach().numpy() for name, leaf in named_leaves(
        tt.params_from_jax(tree, cfg, device="cpu"))}


def _hold_step(got, ref_metrics, ref_state, arch, port_leaves=None):
    """``tests/test_torch_lm_train.py``'s bounds on one train step;
    ``port_leaves`` maps a JAX parameter tree to the port's named leaves
    (``arch``'s LM by default)."""
    np.testing.assert_allclose(got["loss"], ref_metrics["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref_metrics["grad_norm"],
                               rtol=GNORM_RTOL)
    np.testing.assert_allclose(got["lr"], ref_metrics["lr"], rtol=1e-6)
    leaves = got["leaves"]
    port_leaves = port_leaves or (lambda tree: _port_leaves(tree, arch))
    want_mu = port_leaves(ref_state.opt_state["mu"])
    want_p = port_leaves(ref_state.params)
    assert {f".opt_state/['mu']/{k}" for k in want_mu} <= set(leaves)
    for name, w in want_mu.items():
        assert _rel(leaves[f".opt_state/['mu']/{name}"], w) <= GRAD_REL, \
            name
    atol = 2 * ref_metrics["lr"] + 1e-6
    for name, w in want_p.items():
        np.testing.assert_allclose(leaves[f".params/{name}"], w, rtol=0,
                                   atol=atol, err_msg=name)
    assert int(leaves[".opt_state/['step']"]) == 1


@pytest.mark.parametrize("arch,mesh", CASES)
def test_partitioned_train_step_matches_the_reference(runs, arch, mesh):
    refs, _, got = runs
    _hold_step(got["train"][arch, mesh], refs[arch]["metrics"],
               refs[arch]["state"], arch)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_partitioned_prefill_matches_the_reference(runs, arch, mesh):
    refs, _, got = runs
    g = got["serve"][arch, mesh]
    assert _rel(g["last"], refs[arch]["last"]) <= F32_REL
    # the cache comes out in the split-KV layout: batch over 'data',
    # the sequence over 'model' (an axis of one rank cuts nothing)
    assert g["cache_placements"] == {
        "2x2": "(Shard(dim=1), Shard(dim=2))",
        "1x4": "(Replicate(), Shard(dim=2))"}[mesh]
    for key in ("k", "v"):
        have, want = g[f"cache_{key}"].astype(np.float32), refs[arch][
            "warm"][key]
        lim = BF16_STEP * np.maximum(np.abs(have), np.abs(want)) + (
            F32_REL * np.abs(want).max())
        assert not (np.abs(have - want) > lim).any(), key


@pytest.mark.parametrize("arch,mesh", CASES)
def test_partitioned_greedy_decode_matches_the_reference(runs, arch, mesh):
    refs, _, got = runs
    g = got["serve"][arch, mesh]
    for i in range(ranks.GEN):
        assert _rel(g["steps"][i], refs[arch]["steps"][i]) <= F32_REL, i
        np.testing.assert_array_equal(g["ids"][i], refs[arch]["ids"][i])


@pytest.mark.parametrize("arch", ranks.LONG_ARCHS)
def test_partitioned_long_context_decode_matches_the_reference(runs, arch):
    """One sequence on (2, 2): the batch below the data axes' extent, so
    the cache's sequence is cut over both axes (the JAX package's
    long-context layout) and each step merges four partial softmaxes."""
    refs, _, got = runs
    g = got["long"][arch]
    assert g["decode_placements"] == "(Shard(dim=2), Shard(dim=2))"
    for i in range(ranks.GEN):
        assert _rel(g["steps"][i], refs[arch]["steps1"][i]) <= F32_REL, i
        np.testing.assert_array_equal(g["ids"][i], refs[arch]["ids1"][i])


def _fro(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("arch", ranks.LONG_ARCHS)
def test_partitioned_long_context_decode_in_bf16_matches_the_reference(
        runs, arch):
    """The long-context decode of one sequence on (2, 2) computing in
    bfloat16 on a bfloat16 cache, fed the float32 run's ids, held by
    ``tests/test_torch_models_lm.py``'s bfloat16 rule: no further from
    the JAX package's float32 logits than twice its own bfloat16 run
    (relative Frobenius norm), and within 5e-2 of that run at every
    element (of the largest magnitude)."""
    refs, _, got = runs
    g = got["long16"][arch]
    assert g["decode_placements"] == "(Shard(dim=2), Shard(dim=2))"
    for i in range(ranks.GEN):
        mine = _fro(g["steps"][i], refs[arch]["steps1"][i])
        theirs = _fro(refs[arch]["steps16"][i], refs[arch]["steps1"][i])
        assert mine <= 2 * theirs, (i, mine, theirs)
        assert _rel(g["steps"][i], refs[arch]["steps16"][i]) <= BF16_REL, i


@pytest.mark.parametrize("window", [None, 24])
def test_split_kv_decode_attention_in_bf16_matches_the_reference(runs,
                                                                 window):
    """The merge of four ranks' partial softmaxes in bfloat16 (the cache's
    sequence cut over both axes of (2, 2)) against the JAX package's
    ``decode_attention`` on the same bfloat16 inputs."""
    refs, _, got = runs
    g, w = got["split_kv"][window], refs["split_kv"][window]
    lim = BF16_STEP * np.maximum(np.abs(g), np.abs(w))
    assert not (np.abs(g - w) > lim).any(), np.abs(g - w).max()


def test_partitioned_masked_train_step_matches_the_reference(runs):
    """A mask whose counts differ between groupings: the micro-batches
    must be the JAX package's contiguous rows (each one averages over
    its own mask count)."""
    refs, _, got = runs
    want = refs["llama3.2-1b"]["masked"]
    assert abs(want["metrics"]["loss"] - refs["llama3.2-1b"]["metrics"][
        "loss"]) > LOSS_RTOL * abs(want["metrics"]["loss"])
    _hold_step(got["masked"], want["metrics"], want["state"], "llama3.2-1b")


def test_checkpoint_on_2x2_resumes_on_1x4_as_the_straight_run(runs):
    _, _, got = runs
    c = got["checkpoint"]
    assert c["step"] == 1
    # every leaf placed on (1, 4) by the rules: wq's heads over 'model'
    # (the 'data' axis of one rank cuts nothing)
    assert c["placed"][".params/['layers']/[0]/['wq']/['w']"] == (
        "(Replicate(), Shard(dim=1))")
    assert c["placed"][".opt_state/['step']"] == "(Replicate(), Replicate())"
    s, r = c["straight"], c["resumed"]
    np.testing.assert_allclose(r["loss"], s["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["grad_norm"], s["grad_norm"],
                               rtol=GNORM_RTOL)
    atol = 2 * s["lr"] + 1e-6
    for name, w in s["leaves"].items():
        np.testing.assert_allclose(r["leaves"][name], w, rtol=0, atol=atol,
                                   err_msg=name)


def test_jax_restore_reads_the_partitioned_checkpoint(runs):
    """The checkpoint the ranks wrote (whole leaves, rank 0) read back by
    the JAX package's ``restore_checkpoint`` into a tree of the port's
    structure: every leaf equals what the ranks gathered, bit for
    bit."""
    _, _, got = runs
    c = got["checkpoint"]
    written = c["written"]
    like = _jax_like(written)
    tree = jtrain.restore_checkpoint(c["path"], like)
    restored, step = tree
    assert step == 1
    flat, _ = jax.tree_util.tree_flatten_with_path(restored)
    assert len(flat) == len(written)
    for (path, leaf), (name, want) in zip(flat, written.items()):
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=name)


def _jax_like(written: dict):
    """A pytree with the leaves' shapes in the port's order: a list in
    the checkpoint's leaf order (the JAX package flattens a list by
    index)."""
    return [np.zeros(w.shape, w.dtype) for w in written.values()]


def test_planted_all_kv_heads_fault_misses_the_loss(runs):
    refs, _, got = runs
    bad, want = got["fault"]["loss"], refs["llama3.2-1b"]["metrics"]["loss"]
    assert abs(bad - want) > LOSS_RTOL * abs(want), (bad, want)
    good = got["train"]["llama3.2-1b", "1x4"]["loss"]
    assert abs(good - want) <= LOSS_RTOL * abs(want)


def test_kept_cast_of_a_dtensor_follows_its_version_counter(runs):
    _, _, got = runs
    assert got["cast"] == {"kept": True, "version_moved": True,
                           "remade": True, "equal": True,
                           "placements": "(Shard(dim=0), Replicate())"}


def test_kv_head_slice_reads_the_query_heads_own_kv_heads():
    from repro_torch.models.attention import kv_head_slice

    # llama3.2-1b: 32 heads, 8 KV heads, model 16: a KV head per rank
    assert [kv_head_slice(32, 8, 16, r) for r in range(16)] == [
        (r // 2, r // 2 + 1) for r in range(16)]
    # command-r-plus-104b: 96 heads, 8 KV heads (12 queries each)
    assert kv_head_slice(96, 8, 16, 1) == (0, 1)
    assert kv_head_slice(96, 8, 16, 2) == (1, 2)
    # smoke llama on model 4: 8 heads, 2 KV heads
    assert [kv_head_slice(8, 2, 4, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    # a rank whose queries straddle two KV heads unevenly: no slice
    assert kv_head_slice(12, 3, 4, 1) is None


def test_constrain_returns_a_plain_tensor_as_it_is():
    from repro_torch.models.sharding import constrain

    x = torch.zeros(2, 3, 4)
    assert constrain(x, "dp", None, "tp") is x
    with pytest.raises(ValueError, match="2 axes for rank-3"):
        constrain(x, "dp", None)


def test_make_mesh_needs_a_world_of_its_size():
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh((2, 2))
    with pytest.raises(ValueError, match="name the axes"):
        make_mesh((2, 2, 2, 2))
