"""The port's LM training path held against the JAX package on the CPU,
at the ``smoke()`` widths: the gradient of ``loss_fn`` (llama3.2-1b, and
with a small ``attn_block_size`` so that the JAX package's blocked
attention runs), one ``make_train_step`` step of each of the five LM
configs, and the port's own properties (accumulation, remat, bfloat16
gradients into float32 masters, the kept casts after a step, the
blocked attention's block remat).

Weights are drawn with numpy in the JAX package's ``init_params`` shapes
(``jax.eval_shape``; its own init costs a compile a config) and carried
over with ``params_from_jax`` / ``train_state_from_jax``; tokens come
from numpy.  Each JAX function is jitted once per module.  Compute is
float32 in both packages wherever they are compared.  Tolerances: the
loss within rtol 1e-5 and each gradient leaf within 1e-4 of its largest
magnitude (float32 sums reassociated through the layers: K4's backward
against autodiff of the JAX package's attention); ``grad_norm`` within
rtol 1e-4.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.transformer as jt
import repro.train as jtrain
import repro_torch.configs as tcfg
import repro_torch.models.attention as tattn
import repro_torch.models.transformer as tt
from repro_torch.models.layers import cast_weight
from repro_torch.train import (
    AdamWConfig,
    init_train_state,
    make_train_step,
    train_state_from_jax,
)
from repro_torch.train.tree import named_leaves

ARCHS = [a for a in tcfg.ARCH_IDS
         if tcfg.get_config(a, True).family == "lm"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GNORM_RTOL = 1e-4
B, S = 2, 32

_PARAMS = {}


def _configs(arch, dtype="float32", **kw):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jcfg.get_config(arch, True).model,
                                compute_dtype=jd, **kw),
            dataclasses.replace(tcfg.get_config(arch, True).model,
                                compute_dtype=td, **kw))


def _np_params(arch):
    """``arch``'s smoke weights in the JAX package's pytree, drawn with
    numpy in its scales (fan-in**-0.5, the table's d**-0.5, norms at 1)."""
    if arch not in _PARAMS:
        jc = jcfg.get_config(arch, True).model
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

        _PARAMS[arch] = jax.tree_util.tree_map_with_path(draw, shapes)
    return _PARAMS[arch]


def _tokens(vocab, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batch_j(toks):
    return {"tokens": jnp.asarray(toks),
            "labels": jnp.asarray(np.roll(toks, -1, axis=1))}


def _batch_t(toks):
    t = torch.from_numpy(toks).long()
    return {"tokens": t, "labels": torch.roll(t, -1, dims=1)}


def _rel(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _named(tree):
    return dict(tree.named_parameters())


# --------------------------------------------------------------------------
# the loss gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("block,remat", [(None, False), (8, False),
                                         (None, True)])
def test_loss_gradient_matches_the_reference(block, remat):
    """llama3.2-1b smoke in float32: ``loss_fn``'s value and every
    gradient leaf against ``jax.value_and_grad``.  ``block`` 8 sends the
    JAX package's global layers (S = 32 > 2 x 8) through its blocked,
    block-rematted attention; the port's run K4's plain backward.
    ``remat`` (off in ``smoke()``) rematerialises each layer in both."""
    kw = {"remat": remat}
    if block is not None:
        kw["attn_block_size"] = block
    jc, tc = _configs("llama3.2-1b", **kw)
    np_params = _np_params("llama3.2-1b")
    toks = _tokens(jc.vocab, 1)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, jc, b)))(
        jax.tree.map(jnp.asarray, np_params), _batch_j(toks))
    params = tt.params_from_jax(np_params, tc, device="cpu")
    state = init_train_state(params)
    loss = tt.loss_fn(state.params, tc, _batch_t(toks))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    want = _named(tt.params_from_jax(jax.tree.map(np.asarray, want_g), tc,
                                     device="cpu"))
    got = _named(params)
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert _rel(p.grad, want[name].numpy()) <= GRAD_REL, name


# --------------------------------------------------------------------------
# one train step of each LM config
# --------------------------------------------------------------------------

_STEPS = {}


def _jax_step(arch):
    """The JAX package's jitted train step of ``arch`` (float32), once."""
    if arch not in _STEPS:
        jc, _ = _configs(arch)
        _STEPS[arch] = jax.jit(jtrain.make_train_step(
            lambda p, b: jt.loss_fn(p, jc, b),
            jtrain.AdamWConfig(total_steps=10)))
    return _STEPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """One ``make_train_step`` step from the same state and tokens: the
    loss within rtol 1e-5, ``grad_norm`` within rtol 1e-4, the first
    moment ``mu`` (``(1 - b1)`` times the clipped gradient after one
    step) leaf by leaf within 1e-4 of each leaf's largest magnitude, and
    every parameter after the step within 2 x that step's ``lr`` + 1e-6.
    ``mu`` holds each config's gradient to the JAX package's per leaf
    (the router, the experts, local layers, the parallel block).  The
    first AdamW step moves each weight by about ``lr`` times the sign of
    its gradient whatever the gradient's size (``m / sqrt(v)`` is
    ``g / |g|``), so a weight whose gradient is ~0 in both packages may
    move either way: the parameters' bound is the two moves' largest
    difference."""
    jc, tc = _configs(arch)
    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray,
                                                  _np_params(arch)))
    toks = _tokens(jc.vocab, 2)
    jnew, jm = _jax_step(arch)(jstate, _batch_j(toks))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), tc,
                                 device="cpu")
    step = make_train_step(lambda p, b: tt.loss_fn(p, tc, b),
                           AdamWConfig(total_steps=10))
    state, m = step(state, _batch_t(toks))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=GNORM_RTOL)
    np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
    assert int(state.opt_state["step"]) == int(jnew.opt_state["step"]) == 1
    want_mu = dict(named_leaves(tt.params_from_jax(
        jax.tree.map(np.asarray, jnew.opt_state["mu"]), tc, device="cpu")))
    got_mu = dict(named_leaves(state.opt_state["mu"]))
    assert set(got_mu) == set(want_mu)
    for name, mu in got_mu.items():
        assert _rel(mu, want_mu[name].numpy()) <= GRAD_REL, name
    atol = 2 * float(jm["lr"]) + 1e-6
    want = _named(tt.params_from_jax(jax.tree.map(np.asarray, jnew.params),
                                     tc, device="cpu"))
    for name, p in _named(state.params).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# the port's own properties
# --------------------------------------------------------------------------

def _smoke_state(arch="llama3.2-1b", dtype="float32", **kw):
    _, tc = _configs(arch, dtype, **kw)
    return tc, init_train_state(tt.params_from_jax(_np_params(arch), tc,
                                                   device="cpu"))


def test_grad_accumulation_matches_full_batch():
    """``accum_steps`` 2 against 1 on the same batch: micro-batch means of
    equal size average to the full mean (rtol 1e-4, the JAX test's), and
    so do the gradients."""
    tc, s1 = _smoke_state()
    _, s2 = _smoke_state()
    batch = _batch_t(_tokens(tc.vocab, 3, b=4, s=16))
    out = []
    for state, accum in ((s1, 1), (s2, 2)):
        step = make_train_step(lambda p, b: tt.loss_fn(p, tc, b),
                               AdamWConfig(), accum_steps=accum)
        out.append(step(state, batch))
    (a, ma), (b, mb) = out
    np.testing.assert_allclose(ma["loss"].item(), mb["loss"].item(),
                               rtol=1e-4)
    np.testing.assert_allclose(ma["grad_norm"].item(),
                               mb["grad_norm"].item(), rtol=1e-4)
    for pa, pb in zip(a.params.parameters(), b.params.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0,
                                   atol=2 * ma["lr"].item() + 1e-7)


def _grads(tc, params, toks):
    for p in params.parameters():
        p.grad = None
    tt.loss_fn(params, tc, _batch_t(toks)).backward()
    return [p.grad.clone() for p in params.parameters()]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b",
                                  "qwen3-moe-235b-a22b"])
def test_remat_on_and_off_give_the_same_gradients(arch):
    tc, state = _smoke_state(arch)
    toks = _tokens(tc.vocab, 4)
    on = _grads(dataclasses.replace(tc, remat=True), state.params, toks)
    off = _grads(dataclasses.replace(tc, remat=False), state.params, toks)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_remat_keeps_fewer_tensors_for_the_backward():
    """With ``remat`` the forward keeps the layer inputs only: fewer saved
    tensors than without."""
    tc, state = _smoke_state()
    toks = _tokens(tc.vocab, 5)
    counts = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        n = [0]

        def pack(t, n=n):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tt.loss_fn(state.params, cfg, _batch_t(toks))
        counts.append(n[0])
    assert counts[0] < counts[1] / 2, counts


def test_bf16_compute_gradients_reach_the_float32_masters():
    """bfloat16 compute: every weight, the attention projections through
    the K4 route included, gets a finite, non-zero float32 gradient."""
    tc, state = _smoke_state(dtype="bfloat16")
    toks = _tokens(tc.vocab, 6)
    tt.loss_fn(state.params, tc, _batch_t(toks)).backward()
    for name, p in state.params.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, name
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name


def test_prefill_after_a_step_reads_the_new_weights():
    """Serving keeps each weight's bfloat16 cast; an optimizer step
    changes the weights in place, and the next prefill casts anew: it
    equals a prefill of a fresh copy of the stepped weights."""
    tc, state = _smoke_state(dtype="bfloat16")
    toks = torch.from_numpy(_tokens(tc.vocab, 7)).long()
    with torch.no_grad():
        before, _ = tt.prefill(state.params, tc, toks)
    wq = state.params["layers"][0]["wq"]["w"]
    kept = wq._compute_cast[1]
    with torch.no_grad():
        assert cast_weight(wq, torch.bfloat16) is kept
    step = make_train_step(lambda p, b: tt.loss_fn(p, tc, b),
                           AdamWConfig(lr=1e-2, warmup_steps=1))
    state, _ = step(state, _batch_t(toks.numpy().astype(np.int32)))
    with torch.no_grad():
        after, _ = tt.prefill(state.params, tc, toks)
        fresh = copy.deepcopy(state.params)
        for p in fresh.parameters():
            if hasattr(p, "_compute_cast"):
                del p._compute_cast
        want, _ = tt.prefill(fresh, tc, toks)
        assert cast_weight(wq, torch.bfloat16) is not kept
    assert torch.equal(after, want)
    assert not torch.equal(after, before)


def test_training_casts_are_differentiable_and_kept_nowhere():
    w = torch.nn.Parameter(torch.randn(3, 4))
    c = cast_weight(w, torch.bfloat16)
    assert c.grad_fn is not None and not hasattr(w, "_compute_cast")
    c.float().sum().backward()
    assert torch.equal(w.grad, torch.ones(3, 4))
    with torch.no_grad():
        kept = cast_weight(w, torch.bfloat16)
    assert kept.grad_fn is None and w._compute_cast[1] is kept


@pytest.mark.parametrize("use_scan", [True, False])
def test_blocked_attention_gradient_with_and_without_its_block_remat(
        use_scan):
    """``blocked_attention``'s gradient (block body rematted with
    ``use_scan``) against ``naive_attention``'s, windowed and GQA, float32
    (1e-5 of the largest magnitude)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_()
        for shape in ((2, 40, 4, 8), (2, 40, 2, 8), (2, 40, 2, 8)))
    dout = torch.from_numpy(rng.standard_normal((2, 40, 4, 8)).astype(
        np.float32))
    want = torch.autograd.grad(tattn.naive_attention(q, k, v, window=12),
                               (q, k, v), dout)
    out = tattn.blocked_attention(q, k, v, window=12, block_size=16,
                                  use_scan=use_scan)
    got = torch.autograd.grad(out, (q, k, v), dout)
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) <= 1e-5
