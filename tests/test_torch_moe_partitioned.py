"""The MoE LM partitioned over a ``(data, model)`` mesh by DTensor
placements (``models.moe``'s partitioned route through ``launch.tasks``'
cells), on four ``gloo`` ranks, held against the JAX package on the CPU.

One spawn (``launch.mesh.spawn_ranks``, a 180 s deadline) runs every
case of ``tests/torch_moe_ranks.py`` (which imports no JAX) on (data 2,
model 2) and (data 1, model 4).  Cases (``torch_moe_ranks.CASES``), each
at ``smoke()`` widths in float32 compute: qwen3-moe (8 experts, top-2)
on the global route, once at the default capacity and once at
``capacity_factor=0.5``, where the JAX reference drops slots (asserted);
the same with ``n_groups=4`` (the grouped route: 2 groups a data rank
on (2, 2)) and with ``n_groups=3`` (3 groups do not divide 'data' 2:
every rank routes every group); llama4-maverick (4 experts, top-1, a
shared expert, MoE every 2nd layer, chunked local layers).  Weights are
drawn with numpy in the JAX package's shapes and carried into both
packages (``params_from_jax``).  This process computes the JAX
package's answers first and pickles the inputs.

Held, at ``tests/test_torch_lm_partitioned.py``'s tolerances (those of
``tests/test_torch_lm_train.py`` and ``tests/test_torch_models_lm.py``):
the train step of two micro-batches against ``make_train_step`` (loss
rtol 1e-5, ``grad_norm`` 1e-4, ``lr`` 1e-6, each first moment within
1e-4 of its largest magnitude, each parameter within 2 ``lr`` + 1e-6);
the forward's aux loss within 1e-5 relative; the prefill's last logits
and four greedy decode steps (ids equal, logits within 1e-5 of the
largest magnitude).  A checkpoint written on (2, 2) and restored on
(1, 4) takes one more step equal to the straight run's second, and the
JAX package's ``restore_checkpoint`` reads it.  Each planted fault (a
rank routing its own data rows alone on the global route at the binding
capacity; the load-balance loss as the mean of the ranks' own losses;
micro-batches cut from each rank's own rows) misses the JAX package's
loss.
"""
import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jcfg
import repro.models.moe as jmoe
import repro.models.transformer as jt
import repro.train as jtrain
from repro_torch.launch.mesh import spawn_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_moe_ranks as ranks  # noqa: E402
from test_torch_lm_partitioned import (F32_REL, GNORM_RTOL,  # noqa: E402
                                       LOSS_RTOL, _hold_step, _jax_like,
                                       _np_params, _rel)

WORLD = 4
AUX_RTOL = 1e-5
CASES = [(c, m) for c in ranks.CASES for m in ranks.MESHES]


def _jcfg(case):
    arch, fields, _ = ranks.CASES[case]
    model = jcfg.get_config(arch, True).model
    return dataclasses.replace(model, compute_dtype=jnp.float32,
                               moe=dataclasses.replace(model.moe, **fields))


def _tokens(vocab, s, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (ranks.B, s)).astype(np.int32)


def _batch_j(toks):
    return {"tokens": jnp.asarray(toks),
            "labels": jnp.asarray(np.roll(toks, -1, axis=1))}


def _dropped_slots(jc, jparams, toks) -> int:
    """Slots the JAX package's global route drops in a forward of
    ``toks`` (its ``_dispatch_group`` wrapped to report them)."""
    real = jmoe._dispatch_group
    seen = []

    def counting(xt, logits, cfg, cap):
        x_e, aux_in = real(xt, logits, cfg, cap)
        jax.debug.callback(lambda n: seen.append(int(n)),
                           jnp.sum(~aux_in[3]))
        return x_e, aux_in

    jmoe._dispatch_group = counting
    try:
        jax.block_until_ready(jt.forward(jparams, jc, jnp.asarray(toks)))
        jax.effects_barrier()
    finally:
        jmoe._dispatch_group = real
    return sum(seen)


def _reference(case, params, toks):
    """The JAX package's train step (2 micro-batches), forward aux loss,
    prefill and ``GEN`` greedy decode steps on a float32 cache warmed by
    the prefill."""
    jc = _jcfg(case)
    jparams = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jtrain.make_train_step(
        lambda p, b: jt.loss_fn(p, jc, b), jtrain.AdamWConfig(),
        ranks.ACCUM))
    new, m = step(jtrain.init_train_state(jparams), _batch_j(toks))
    out = {"state": jax.tree.map(np.asarray, new),
           "metrics": {k: float(v) for k, v in m.items()}}
    _, aux = jax.jit(lambda p, t: jt.forward(p, jc, t))(jparams,
                                                        jnp.asarray(toks))
    out["aux"] = float(aux)
    if case == "bind":
        n = ranks.B // ranks.ACCUM
        out["dropped"] = {"micro_batch": _dropped_slots(jc, jparams,
                                                        toks[:n]),
                          "batch": _dropped_slots(jc, jparams, toks)}
    s = ranks.seq_len(case)
    last, warm = jax.jit(lambda p, t: jt.prefill(p, jc, t))(
        jparams, jnp.asarray(toks))
    cache = jt.init_cache(jc, ranks.B, s + ranks.GEN, dtype=jnp.float32)
    cache = {k: jax.lax.dynamic_update_slice_in_dim(
        cache[k], warm[k].astype(jnp.float32), 0, axis=2) for k in cache}
    serve = jax.jit(lambda p, c, t, pos: jt.serve_step(p, jc, c, t, pos))
    first = np.asarray(jnp.argmax(last, axis=-1).astype(jnp.int32))
    tok = jnp.asarray(first)
    steps, ids = [], []
    for i in range(ranks.GEN):
        lg, cache = serve(jparams, cache, tok, jnp.int32(s + i))
        steps.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        ids.append(np.asarray(tok))
    out.update({"last": np.asarray(last),
                "warm": {k: np.asarray(v.astype(jnp.float32))
                         for k, v in warm.items()},
                "first": first, "steps": steps, "ids": ids})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference answers, the ranks' results)``."""
    out_dir = str(tmp_path_factory.mktemp("moe_ranks"))
    inputs, refs = {}, {}
    for i, case in enumerate(ranks.CASES):
        arch = ranks.CASES[case][0]
        params = _np_params(arch)
        vocab, s = _jcfg(case).vocab, ranks.seq_len(case)
        toks = _tokens(vocab, s, 30 + i)
        refs[case] = _reference(case, params, toks)
        inputs[case] = {"params": params, "tokens": toks,
                        "tokens2": _tokens(vocab, s, 40 + i),
                        "warm": refs[case]["warm"],
                        "first": refs[case]["first"]}
    in_path = os.path.join(out_dir, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    spawn_ranks(ranks.run_cases, WORLD,
                (os.path.join(out_dir, "store"), in_path, out_dir),
                deadline_s=180.0)
    with open(os.path.join(out_dir, "moe_ranks.pkl"), "rb") as f:
        return refs, pickle.load(f)


def _arch(case):
    return ranks.CASES[case][0]


@pytest.mark.parametrize("case,mesh", CASES)
def test_partitioned_moe_train_step_matches_the_reference(runs, case, mesh):
    refs, got = runs
    _hold_step(got["train"][case, mesh], refs[case]["metrics"],
               refs[case]["state"], _arch(case))


@pytest.mark.parametrize("case,mesh", CASES)
def test_partitioned_moe_aux_loss_matches_the_reference(runs, case, mesh):
    """The forward's aux loss (the load-balance and z-losses summed over
    the MoE layers) is the global one: the router's sums over every data
    rank's tokens before the product."""
    refs, got = runs
    np.testing.assert_allclose(got["aux"][case, mesh], refs[case]["aux"],
                               rtol=AUX_RTOL)


@pytest.mark.parametrize("case,mesh", CASES)
def test_partitioned_moe_prefill_and_decode_match_the_reference(runs, case,
                                                                mesh):
    refs, got = runs
    g = got["serve"][case, mesh]
    assert _rel(g["last"], refs[case]["last"]) <= F32_REL
    for i in range(ranks.GEN):
        assert _rel(g["steps"][i], refs[case]["steps"][i]) <= F32_REL, i
        np.testing.assert_array_equal(g["ids"][i], refs[case]["ids"][i])


def test_binding_capacity_drops_slots_in_the_reference(runs):
    """At ``capacity_factor=0.5`` the JAX package's global route drops
    slots, in a training micro-batch and in the whole batch: a route
    that chose its slots over fewer tokens would differ."""
    refs, _ = runs
    dropped = refs["bind"]["dropped"]
    assert dropped["micro_batch"] > 0 and dropped["batch"] > 0, dropped


@pytest.mark.parametrize("fault,case", [("own_rows_route", "bind"),
                                        ("mean_of_rank_losses", "global"),
                                        ("own_rows_micro_batches",
                                         "global")])
def test_planted_moe_fault_misses_the_reference(runs, fault, case):
    """Each planted fault on (2, 2) misses the JAX package's loss (by
    5e-4 to 9e-3 of it where first run) and, where it changes the
    forward, its aux loss; the partitioned step of the same case meets
    both."""
    refs, got = runs
    bad = got["faults"][fault]
    want = refs[case]["metrics"]["loss"]
    assert abs(bad["step"]["loss"] - want) > LOSS_RTOL * abs(want), fault
    assert abs(got["train"][case, "2x2"]["loss"] - want) <= (
        LOSS_RTOL * abs(want))
    if "aux" in bad:
        want = refs[case]["aux"]
        assert abs(bad["aux"] - want) > AUX_RTOL * abs(want), (
            bad["aux"], want)


def test_moe_checkpoint_on_2x2_resumes_on_1x4_as_the_straight_run(runs):
    _, got = runs
    c = got["checkpoint"]
    assert c["step"] == 1
    # the experts over 'model' (4), d_model whole (the 'data' axis of
    # one rank cuts nothing)
    assert c["placed"][".params/['layers']/[0]/['moe']/['w_gate']"] == (
        "(Replicate(), Shard(dim=0))")
    assert c["placed"][".opt_state/['mu']/['layers']/[1]/['moe']/"
                       "['w_down']"] == "(Replicate(), Shard(dim=0))"
    s, r = c["straight"], c["resumed"]
    np.testing.assert_allclose(r["loss"], s["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["grad_norm"], s["grad_norm"],
                               rtol=GNORM_RTOL)
    atol = 2 * s["lr"] + 1e-6
    for name, w in s["leaves"].items():
        np.testing.assert_allclose(r["leaves"][name], w, rtol=0, atol=atol,
                                   err_msg=name)


def test_jax_restore_reads_the_partitioned_moe_checkpoint(runs):
    """The MoE checkpoint (whole expert leaves, written by rank 0) read
    back by the JAX package's ``restore_checkpoint``: every leaf equals
    what the ranks gathered, bit for bit."""
    _, got = runs
    c = got["checkpoint"]
    written = c["written"]
    restored, step = jtrain.restore_checkpoint(c["path"],
                                               _jax_like(written))
    assert step == 1
    flat, _ = jax.tree_util.tree_flatten_with_path(restored)
    assert len(flat) == len(written)
    assert any("['moe']/['w_gate']" in name for name in written)
    for (_, leaf), (name, want) in zip(flat, written.items()):
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=name)
