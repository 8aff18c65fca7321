"""The port's GNN side held against the JAX package on the CPU, at the
four ``smoke()`` configs (gat-cora, pna, nequip, mace).

The graphs are the reference's ``random_graph`` draws (the port's own
``random_graph`` gives the same arrays from the same seed), the weights
the reference's ``init_params`` carried over by ``params_from_jax``.
Each JAX function is jitted once per module.  Held:

* the forward and the loss within 1e-4 of the output's largest
  magnitude; every gradient leaf within 1e-4 of its largest magnitude
  (a leaf whose reference gradient vanishes by symmetry, a 1 x 1 -> 1
  CG path of a vector with itself in MACE, is float noise of ~1e-11 in
  both packages: its scale is floored at 1e-7 of the whole gradient's
  largest magnitude); one AdamW step's parameters within 5e-4 (the
  JAX package's sharded-step bound);
* NequIP / MACE energy invariance and force rotation, as
  ``tests/test_models_gnn.py``; ``forces`` against ``jax.grad``;
* the CG, Wigner and spherical-harmonic tables to 1e-12;
* PNA's edge-mask padding invariance;
* ``get_config`` for the four ids, field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.gnn as jgnn
import repro.models.gnn.irreps as jirr
import repro.train as jtrain
import repro_torch.configs as tcfg
import repro_torch.models.gnn.irreps as tirr
from repro.models.gnn import equivariant as jeq
from repro.models.gnn import gat as jgat
from repro.models.gnn import pna as jpna
from repro_torch.models.gnn import equivariant as teq
from repro_torch.models.gnn import gat as tgat
from repro_torch.models.gnn import graph_from_jax, random_graph
from repro_torch.models.gnn import pna as tpna
from repro_torch.train import (
    AdamWConfig,
    init_train_state,
    make_train_step,
    train_state_from_jax,
)
from repro_torch.train.tree import named_leaves

ARCHS = ("gat-cora", "pna", "nequip", "mace")
MODS = {"gat-cora": (jgat, tgat), "pna": (jpna, tpna),
        "nequip": (jeq, teq), "mace": (jeq, teq)}
REL = 1e-4
STEP_TOL = 5e-4
OPT = AdamWConfig(lr=1e-2, total_steps=10)

_CACHE = {}


def _graph(arch):
    cfg = jcfg.get_config(arch, True).model
    if arch in ("nequip", "mace"):
        g = jgnn.random_graph(24, 80, with_positions=True,
                              n_species=cfg.n_species, seed=3)
        return dataclasses.replace(g, labels=jnp.zeros((1,), jnp.float32))
    return jgnn.random_graph(30, 90, d_feat=cfg.d_in,
                             n_classes=cfg.n_classes, seed=2)


def _ref(arch):
    """The reference's config, graph, numpy weights, (loss, gradient),
    forward, one AdamW step's state: computed once per module."""
    if arch not in _CACHE:
        jm, _ = MODS[arch]
        cfg = jcfg.get_config(arch, True).model
        g = _graph(arch)
        params = jm.init_params(jax.random.PRNGKey(0), cfg)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss_fn(p, cfg, b)))(params, g)
        out = jax.jit(lambda p, b: jm.forward(p, cfg, b))(params, g)
        state = jtrain.init_train_state(params)
        step = jax.jit(jtrain.make_train_step(
            lambda p, b: jm.loss_fn(p, cfg, b),
            jtrain.AdamWConfig(lr=OPT.lr, total_steps=OPT.total_steps)))
        state1, m1 = step(state, g)
        _CACHE[arch] = dict(
            cfg=cfg, g=g, params=jax.tree.map(np.asarray, params),
            loss=float(loss), grads=jax.tree.map(np.asarray, grads),
            out=np.asarray(out), state0=jax.tree.map(np.asarray, state),
            state1=jax.tree.map(np.asarray, state1),
            loss1=float(m1["loss"]))
    return _CACHE[arch]


def _port(arch):
    ref = _ref(arch)
    _, tm = MODS[arch]
    tc = tcfg.get_config(arch, True).model
    params = tm.params_from_jax(ref["params"], tc, device="cpu")
    return tm, tc, params, graph_from_jax(ref["g"], device="cpu")


def _rel(got, want, floor=1e-30):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), floor))


# --------------------------------------------------------------------------
# configs and graphs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_config_field_for_field(arch, smoke):
    got, want = tcfg.get_config(arch, smoke), jcfg.get_config(arch, smoke)
    assert got.family == want.family == "gnn"
    assert (got.arch_id, got.source, got.notes) == (want.arch_id,
                                                    want.source, want.notes)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(want.model)
    assert type(got.model).__name__ == type(want.model).__name__
    assert set(got.shapes) == set(want.shapes)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=30, n_edges=90, d_feat=8, n_classes=4, seed=2),
    dict(n_nodes=3840, n_edges=8192, d_feat=16, with_positions=True,
         n_graphs=128, seed=7),
    dict(n_nodes=25, n_edges=70, with_positions=True, n_species=4, seed=1),
])
def test_random_graph_same_draws(kw):
    want = jgnn.random_graph(**kw)
    got = random_graph(**kw, device="cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, int):
            assert a == b, f.name
        elif b is None:
            assert a is None, f.name
        else:
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name
            assert a.numpy().dtype == np.asarray(b).dtype, f.name


# --------------------------------------------------------------------------
# irreps tables
# --------------------------------------------------------------------------

def test_cg_tables_equal_the_reference():
    paths = tirr.allowed_paths(2)
    assert paths == jirr.allowed_paths(2) and len(paths) == 15
    for p in tirr.allowed_paths(3):
        np.testing.assert_allclose(tirr.real_cg(*p), jirr.real_cg(*p),
                                   rtol=0, atol=1e-12)


def test_wigner_and_sph_harm_equal_the_reference():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((64, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    for _ in range(3):
        rot = tirr._random_rotation(rng)
        for l in range(4):
            np.testing.assert_allclose(tirr.wigner_d_np(l, rot),
                                       jirr.wigner_d_np(l, rot), atol=1e-12)
    for l in range(4):
        want = jirr.sph_harm_np(l, pts)
        np.testing.assert_allclose(tirr.sph_harm_np(l, pts), want,
                                   atol=1e-12)
        got = tirr.sph_harm(l, torch.from_numpy(pts))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    r = np.linspace(0.0, 6.0, 50).astype(np.float32)
    np.testing.assert_allclose(
        tirr.bessel_basis(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(jirr.bessel_basis(jnp.asarray(r), 8, 5.0)),
        rtol=1e-5, atol=1e-6)


def test_random_rotation_same_draws():
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        np.testing.assert_array_equal(tirr._random_rotation(a),
                                      jirr._random_rotation(b))


# --------------------------------------------------------------------------
# forward, loss, gradients, one train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference(arch):
    ref = _ref(arch)
    tm, tc, params, g = _port(arch)
    with torch.no_grad():
        out = tm.forward(params, tc, g)
        loss = tm.loss_fn(params, tc, g)
    assert _rel(out, ref["out"]) <= REL
    assert abs(loss.item() - ref["loss"]) <= REL * max(abs(ref["loss"]), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference(arch):
    ref = _ref(arch)
    tm, tc, params, g = _port(arch)
    state = init_train_state(params)
    tm.loss_fn(state.params, tc, g).backward()
    want = jax.tree.leaves(ref["grads"])
    scale = max(np.abs(w).max() for w in want)
    got = named_leaves(params)
    assert len(got) == len(want)
    for (name, p), w in zip(got, want):
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel(grad, w, floor=1e-7 * scale) <= REL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(arch):
    ref = _ref(arch)
    tm, tc, _, g = _port(arch)
    state = train_state_from_jax(ref["state0"], tc, device="cpu",
                                 params_from_jax=tm.params_from_jax)
    step = make_train_step(lambda p, b: tm.loss_fn(p, tc, b), OPT)
    state, m = step(state, g)
    assert abs(m["loss"].item() - ref["loss1"]) <= STEP_TOL
    want = jax.tree.leaves(ref["state1"].params)
    for (name, p), w in zip(named_leaves(state.params), want):
        err = float(np.abs(p.detach().numpy() - w).max())
        assert err <= STEP_TOL, (name, err)
    assert int(state.opt_state["step"]) == 1


@pytest.mark.parametrize("arch", ["gat-cora", "pna"])
def test_message_passing_loss_falls(arch):
    """Four steps from the port's own init (``init_params`` from a
    generator): finite, and the loss falls, as the reference's smoke."""
    _, tm = MODS[arch]
    cfg = tcfg.get_config(arch, True).model
    g = random_graph(30, 90, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                     seed=2, device="cpu")
    params = tm.init_params(torch.Generator().manual_seed(0), cfg)
    out = tm.forward(params, cfg, g)
    assert out.shape == (30, cfg.n_classes) and torch.isfinite(out).all()
    step = make_train_step(lambda p, b: tm.loss_fn(p, cfg, b), OPT)
    state = init_train_state(params)
    losses = [step(state, g)[1]["loss"].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# --------------------------------------------------------------------------
# the equivariant models' properties
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_energy_is_e3_invariant(arch):
    ref = _ref(arch)
    tm, tc, params, g = _port(arch)
    rng = np.random.default_rng(4)
    rot = torch.from_numpy(tirr._random_rotation(rng).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    with torch.no_grad():
        e0 = tm.forward(params, tc, g)
        e1 = tm.forward(params, tc, dataclasses.replace(
            g, positions=g.positions @ rot.T + t))
    np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-3, atol=1e-3)
    assert _rel(e0, ref["out"]) <= REL


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_forces_match_the_reference_and_rotate(arch):
    """``forces`` against ``jax.grad`` of the reference's energy, on the
    graph and on its rotation; rotated, the forces rotate, with the
    reference test's tolerance for NequIP.  MACE's float32 forces rotate
    less exactly (in the JAX package too: 1.66e-2 of their largest
    magnitude on this graph), so MACE is held to 2e-2 of it."""
    ref = _ref(arch)
    tm, tc, params, g = _port(arch)
    jm, _ = MODS[arch]
    jp = jax.tree.map(jnp.asarray, ref["params"])
    jforces = jax.jit(lambda p, b: jm.forces(p, ref["cfg"], b))
    rot = tirr._random_rotation(np.random.default_rng(8)).astype(np.float32)
    g_rot = dataclasses.replace(ref["g"], positions=ref["g"].positions
                                @ jnp.asarray(rot).T)
    f0 = teq.forces(params, tc, g)
    f1 = teq.forces(params, tc, graph_from_jax(g_rot, device="cpu"))
    assert _rel(f0, jforces(jp, ref["g"])) <= REL
    assert _rel(f1, jforces(jp, g_rot)) <= REL
    want = (f0 @ torch.from_numpy(rot).T).numpy()
    if arch == "nequip":
        np.testing.assert_allclose(f1.numpy(), want, rtol=2e-2, atol=2e-3)
    else:
        assert np.abs(f1.numpy() - want).max() <= 2e-2 * np.abs(want).max()


def test_equivariant_loss_falls():
    cfg = tcfg.get_config("mace", True).model
    g = random_graph(20, 60, with_positions=True, n_species=cfg.n_species,
                     seed=1, device="cpu")
    g = dataclasses.replace(g, labels=torch.zeros(1))
    params = teq.init_params(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(lambda p, b: teq.loss_fn(p, cfg, b),
                           AdamWConfig(lr=1e-3, total_steps=10))
    state = init_train_state(params)
    losses = [step(state, g)[1]["loss"].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_edge_mask_kills_messages():
    """Fully masked edge sets are interchangeable: the output cannot
    depend on which dead edges exist (padding invariance), and equals
    the reference's."""
    jc = jcfg.get_config("pna", True).model
    tc = tcfg.get_config("pna", True).model
    g1 = jgnn.random_graph(10, 20, d_feat=jc.d_in, seed=0)
    g2 = jgnn.random_graph(10, 20, d_feat=jc.d_in, seed=99)
    jp = jpna.init_params(jax.random.PRNGKey(0), jc)
    params = tpna.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    dead1 = dataclasses.replace(g1, edge_mask=jnp.zeros_like(g1.edge_mask))
    dead2 = dataclasses.replace(g1, edge_src=g2.edge_src,
                                edge_dst=g2.edge_dst,
                                edge_mask=jnp.zeros_like(g1.edge_mask))
    with torch.no_grad():
        out1 = tpna.forward(params, tc, graph_from_jax(dead1, "cpu"))
        out2 = tpna.forward(params, tc, graph_from_jax(dead2, "cpu"))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert _rel(out1, jpna.forward(jp, jc, dead1)) <= REL
