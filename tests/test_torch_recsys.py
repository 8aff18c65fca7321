"""BERT4Rec in the port against the JAX package's, on the same numpy
weights and batches: the smoke config and a narrow one with the
production head shape (``embed_dim`` 64, 2 heads of 32, ``max_seq``
200, a few thousand items).

* ``encode``, ``serve_score`` and ``retrieval_score`` within 1e-5 of
  the reference's largest magnitude; ``loss_fn`` and ``loss_sampled``
  within 1e-5 relative;
* every gradient leaf of both losses within 1e-4 of its largest
  magnitude (``jax.grad`` against autograd through K4's plain forward
  and backward);
* five AdamW steps of ``loss_sampled`` whose losses track the
  reference's within 1e-5 and decrease (``tests/test_recsys.py``);
* ``bidirectional_attention`` (the K4 route, its plain version here)
  against the reference's ``naive_attention(causal=False)``;
* the configs and the vocabulary's 512-row alignment.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.attention as jattn
import repro.models.recsys.bert4rec as jb
import repro_torch.configs as tcfg
import repro_torch.models.attention as tattn
import repro_torch.models.recsys.bert4rec as tb
from repro.train import AdamWConfig as JAdamW
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.tree import leaves, named_leaves

F32_REL = 1e-5
GRAD_REL = 1e-4
NARROW = dict(name="bert4rec-narrow", n_items=3000, embed_dim=64,
              n_blocks=2, n_heads=2, max_seq=200)
CONFIGS = ("smoke", "narrow")


def _cfgs(which):
    if which == "smoke":
        return (jcfg.get_config("bert4rec", smoke=True).model,
                tcfg.get_config("bert4rec", smoke=True).model)
    return jb.BERT4RecConfig(**NARROW), tb.BERT4RecConfig(**NARROW)


def _batch(cfg, seed, batch=3, n_masked=4, n_neg=64):
    """Left-padded sequences (PAD = 0), masked positions set to MASK, the
    sampled loss's and the full loss's fields, as numpy."""
    rng = np.random.default_rng(seed)
    s = cfg.max_seq
    items = rng.integers(1, cfg.n_items, (batch, s)).astype(np.int32)
    for i in range(batch):
        items[i, :rng.integers(0, s // 3)] = 0
    pos = np.stack([rng.choice(np.arange(s // 3, s), n_masked,
                               replace=False) for _ in range(batch)])
    pos = pos.astype(np.int32)
    labels = np.take_along_axis(items, pos, axis=1)
    masked = items.copy()
    np.put_along_axis(masked, pos, cfg.mask_id, axis=1)
    full_labels = items.copy()
    loss_mask = np.zeros(items.shape, np.float32)
    np.put_along_axis(loss_mask, pos, 1.0, axis=1)
    return {"items": masked, "masked_pos": pos, "labels": labels,
            "negatives": rng.integers(1, cfg.n_items, n_neg).astype(
                np.int32)}, {"items": masked, "labels": full_labels,
                             "loss_mask": loss_mask}


_CACHE = {}


def _setup(which):
    """(JAX cfg, port cfg, numpy params, port params, sampled batch, full
    batch), made once a config."""
    if which not in _CACHE:
        jc, tc = _cfgs(which)
        params = jax.tree.map(np.asarray,
                              jb.init_params(jax.random.PRNGKey(0), jc))
        sampled, full = _batch(jc, seed=1)
        _CACHE[which] = (jc, tc, params,
                         tb.params_from_jax(params, device="cpu"),
                         sampled, full)
    return _CACHE[which]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _rel(got, want):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_vocab_is_lane_aligned():
    got, want = tcfg.get_config("bert4rec").model, \
        jcfg.get_config("bert4rec").model
    assert got.vocab % 512 == 0
    assert (got.vocab, got.mask_id) == (want.vocab, want.mask_id) == (
        1_000_448, 1_000_001)
    for which in CONFIGS:
        jc, tc = _cfgs(which)
        assert (tc.vocab, tc.mask_id) == (jc.vocab, jc.mask_id)
        assert tc.vocab % 512 == 0


@pytest.mark.parametrize("which", CONFIGS)
def test_init_params_has_the_reference_tree(which):
    jc, tc = _cfgs(which)
    want = jax.eval_shape(lambda: jb.init_params(jax.random.PRNGKey(0), jc))
    got = tb.init_params(torch.Generator().manual_seed(0), tc)
    names = [n for n, _ in named_leaves(got)]
    assert names == [jax.tree_util.keystr(p) .replace("][", "]/[")
                     for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    again = tb.init_params(torch.Generator().manual_seed(0), tc)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(again)))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", CONFIGS)
def test_encode_matches_jax(which):
    jc, tc, params, tp, batch, _ = _setup(which)
    want = jax.jit(lambda p, x: jb.encode(p, jc, x))(
        params, jnp.asarray(batch["items"]))
    got = tb.encode(tp, tc, torch.from_numpy(batch["items"]))
    assert _rel(got, want) <= F32_REL


@pytest.mark.parametrize("which", CONFIGS)
def test_serve_score_matches_jax(which):
    jc, tc, params, tp, batch, _ = _setup(which)
    want = jax.jit(lambda p, x: jb.serve_score(p, jc, x))(
        params, jnp.asarray(batch["items"]))
    got = tb.serve_score(tp, tc, torch.from_numpy(batch["items"]))
    assert got.shape == (3, tc.vocab)
    assert _rel(got, want) <= F32_REL


@pytest.mark.parametrize("which", CONFIGS)
def test_retrieval_score_matches_jax_and_the_full_scores(which):
    jc, tc, params, tp, batch, _ = _setup(which)
    items = batch["items"][:1]
    cand = np.random.default_rng(4).integers(1, jc.n_items, 500).astype(
        np.int32)
    want = jax.jit(lambda p, x, c: jb.retrieval_score(p, jc, x, c))(
        params, jnp.asarray(items), jnp.asarray(cand))
    got = tb.retrieval_score(tp, tc, torch.from_numpy(items),
                             torch.from_numpy(cand))
    assert got.shape == (500,)
    assert _rel(got, want) <= F32_REL
    # tests/test_recsys.py's rule: the candidates' scores are the full
    # catalog's at those ids.
    full = tb.serve_score(tp, tc, torch.from_numpy(items))[0]
    np.testing.assert_allclose(got.numpy(), full.numpy()[cand], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("which", CONFIGS)
def test_losses_match_jax(which):
    jc, tc, params, tp, sampled, full = _setup(which)
    want = float(jax.jit(lambda p, b: jb.loss_sampled(p, jc, b))(
        params, _j(sampled)))
    got = float(tb.loss_sampled(tp, tc, _t(sampled)))
    assert abs(got - want) <= F32_REL * abs(want)
    want = float(jax.jit(lambda p, b: jb.loss_fn(p, jc, b))(
        params, _j(full)))
    got = float(tb.loss_fn(tp, tc, _t(full)))
    assert abs(got - want) <= F32_REL * abs(want)


def test_pad_keys_enter_the_softmax():
    """The reference masks no key (its comment says it does): a PAD
    position's value moves the other positions' outputs in both
    packages alike."""
    jc, tc, params, tp, batch, _ = _setup("smoke")
    items = batch["items"][:1].copy()
    items[0, :4] = 0
    other = params["item_embed"].copy()
    # Move PAD's embedding only (not by a constant: layernorm removes it).
    other[0] += np.random.default_rng(5).standard_normal(other.shape[1])
    tp2 = tb.params_from_jax({**params, "item_embed": other}, "cpu")
    a = tb.encode(tp, tc, torch.from_numpy(items))
    b = tb.encode(tp2, tc, torch.from_numpy(items))
    assert float((a[0, 4:] - b[0, 4:]).abs().max()) > 1e-4
    want = jb.encode({**params, "item_embed": other}, jc,
                     jnp.asarray(items))
    assert _rel(b, want) <= F32_REL


@pytest.mark.parametrize("s,h,hd", [(200, 2, 32), (16, 2, 8), (37, 4, 16)])
def test_bidirectional_attention_matches_naive(s, h, hd):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, h, hd)).astype(np.float32)
               for _ in range(3))
    want = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False)
    got = tattn.bidirectional_attention(*map(torch.from_numpy, (q, k, v)))
    assert _rel(got, want) <= F32_REL
    plain = tattn.naive_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=False)
    assert _rel(plain, want) <= F32_REL


# --------------------------------------------------------------------------
# gradients and training
# --------------------------------------------------------------------------

def _grads(tp, loss):
    ps = leaves(tp)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    loss().backward()
    out = [p.grad.detach().clone() for p in ps]
    for p in ps:
        p.requires_grad_(False)
        p.grad = None
    return out


@pytest.mark.parametrize("loss", ["loss_sampled", "loss_fn"])
@pytest.mark.parametrize("which", CONFIGS)
def test_gradients_match_jax(which, loss):
    jc, tc, params, tp, sampled, full = _setup(which)
    batch = sampled if loss == "loss_sampled" else full
    want = jax.jit(jax.grad(lambda p, b: getattr(jb, loss)(p, jc, b)))(
        params, _j(batch))
    got = _grads(tp, lambda: getattr(tb, loss)(tp, tc, _t(batch)))
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("which", CONFIGS)
def test_adamw_steps_track_jax(which):
    jc, tc, params, _, batch, _ = _setup(which)
    opt = dict(lr=1e-3, total_steps=20)
    jstep = jax.jit(j_make_step(lambda p, b: jb.loss_sampled(p, jc, b),
                                JAdamW(**opt)))
    jstate = j_init_state(jax.tree.map(jnp.asarray, params))
    state = init_train_state(tb.params_from_jax(params, "cpu"))
    step = make_train_step(lambda p, b: tb.loss_sampled(p, tc, b),
                           AdamWConfig(**opt))
    jb_, tb_ = _j(batch), _t(batch)
    got, want = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jb_)
        state, m = step(state, tb_)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    assert all(np.isfinite(got))
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=F32_REL)


@pytest.mark.parametrize("smoke", [False, True])
def test_train_state_from_jax_carries_bert4rec(smoke):
    """``train.train_state_from_jax`` with BERT4Rec's ``params_from_jax``
    keeps the reference's leaves bitwise."""
    from repro_torch.train import train_state_from_jax

    jc, tc = (jcfg.get_config("bert4rec", smoke=True).model,
              tcfg.get_config("bert4rec", smoke=True).model)
    if not smoke:
        jc = dataclasses.replace(jc, n_items=600)
        tc = dataclasses.replace(tc, n_items=600)
    jstate = jax.tree.map(np.asarray, j_init_state(
        jb.init_params(jax.random.PRNGKey(3), jc)))
    state = train_state_from_jax(
        jstate, tc, device="cpu",
        params_from_jax=lambda tree, cfg, dev: tb.params_from_jax(tree, dev))
    for g, w in zip(leaves(state.params), jax.tree.leaves(jstate.params)):
        assert np.array_equal(g.detach().numpy(), w)
    assert int(state.opt_state["step"]) == 0
