"""Parity of the PyTorch port's foundations with the JAX package.

The same inputs, made from a seed with numpy, go through the JAX
reference and its counterpart in ``repro_torch``:

* monoids: exact identities, ``combine``, and the segment fold law
  (bitwise on exact payloads, NaN propagation for float min/max, empty
  segments read the identity, out-of-range ids dropped);
* ``HyperGraph``: degrees, cardinalities, ``padded``, ``sorted_by_dst``,
  ``sub_hypergraph``, ``validate`` and the carry-over ``from_numpy``;
* the programming-model helpers (``tree_map``, ``constant_initial_msg``,
  ``identity_rows``, ``Program.monoid_for``);
* the dataset generator: same seed, same ``src`` / ``dst``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.hypergraph import HyperGraph as JHyperGraph
from repro.data import make_dataset as j_make_dataset
from repro.data import powerlaw_hypergraph as j_powerlaw_hypergraph
from repro.sparse.segment import MONOIDS as J_MONOIDS
from repro_torch.core.api import (
    Program,
    ProcedureOut,
    constant_initial_msg,
    identity_rows,
    tree_leaves,
    tree_map,
)
from repro_torch.core.hypergraph import HyperGraph
from repro_torch.data import make_dataset, powerlaw_hypergraph
from repro_torch.sparse.segment import (
    MONOIDS,
    derive_monoid_for,
    resolve_monoid,
    segment_reduce,
)

settings.register_profile("torch_ci", max_examples=12, deadline=None)
settings.load_profile("torch_ci")

MONOID_NAMES = ("sum", "min", "max", "prod", "or")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


# --------------------------------------------------------------------------
# monoids
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", MONOID_NAMES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_identities_exact(name, dtype):
    got = MONOIDS[name].identity(getattr(torch, dtype))
    want = np.asarray(J_MONOIDS[name].identity(jnp.dtype(dtype)))
    assert np.asarray(got, dtype=dtype) == want.astype(dtype)
    if dtype == "float32" and name in ("min", "max"):
        assert np.isinf(got) and np.sign(got) == (1 if name == "min" else -1)
    if dtype == "int32" and name in ("min", "max"):
        info = np.iinfo(np.int32)
        assert got == (info.max if name == "min" else info.min)


@st.composite
def segment_case(draw):
    n = draw(st.integers(0, 120))
    n_seg = draw(st.integers(1, 30))
    name = draw(st.sampled_from(MONOID_NAMES))
    dtype = draw(st.sampled_from(["float32", "int32"]))
    width = draw(st.sampled_from([(), (3,)]))
    seed = draw(st.integers(0, 100_000))
    rng = np.random.default_rng(seed)
    # ids include out-of-range values (dropped by both packages)
    ids = rng.integers(-2, n_seg + 2, n).astype(np.int32)
    if name == "or":
        x = rng.random((n,) + width) > 0.5
    elif name == "prod" and dtype == "float32":
        x = rng.choice(np.array([-1.0, 0.0, 1.0, 2.0], np.float32),
                       (n,) + width)
    elif dtype == "int32":
        x = rng.integers(-2**31, 2**31, (n,) + width, dtype=np.int64)
        x = x.astype(np.int32)
    else:
        x = rng.integers(-8, 9, (n,) + width).astype(np.float32)
        if name in ("min", "max") and n:
            x[rng.random((n,) + width) < 0.05] = np.nan
    return x, ids, n_seg, name


@given(segment_case())
def test_segment_fold_law_matches_jax(case):
    x, ids, n_seg, name = case
    want = J_MONOIDS[name].segment(jnp.asarray(x), jnp.asarray(ids),
                                   num_segments=n_seg)
    got = MONOIDS[name].segment(torch.as_tensor(x), torch.as_tensor(ids),
                                n_seg)
    assert _same(got, want), (name, x.dtype)
    # the law itself: fold(combine, identity, members) per segment
    for s in range(min(n_seg, 4)):
        acc = torch.full(x.shape[1:], MONOIDS[name].identity(
            torch.as_tensor(x).dtype), dtype=torch.as_tensor(x).dtype)
        for row in torch.as_tensor(x)[torch.as_tensor(ids == s)]:
            acc = MONOIDS[name].combine(acc, row)
        assert _same(acc, got[s]), (name, s)


def test_float_sum_within_reassociation_tolerance():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 4)).astype(np.float32)
    ids = rng.integers(0, 70, 3000).astype(np.int32)
    want = J_MONOIDS["sum"].segment(jnp.asarray(x), jnp.asarray(ids),
                                    num_segments=70)
    got = segment_reduce(torch.as_tensor(x), torch.as_tensor(ids), 70)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", MONOID_NAMES)
def test_combine_matches_jax(name):
    rng = np.random.default_rng(1)
    if name == "or":
        a, b = rng.random(50) > 0.5, rng.random(50) > 0.5
    else:
        a = rng.integers(-5, 6, 50).astype(np.float32)
        b = rng.integers(-5, 6, 50).astype(np.float32)
        a[3], b[7] = np.nan, np.nan
    got = MONOIDS[name].combine(torch.as_tensor(a), torch.as_tensor(b))
    want = J_MONOIDS[name].combine(jnp.asarray(a), jnp.asarray(b))
    assert _same(got, want)


def test_resolve_and_derive_monoid():
    assert resolve_monoid("min") is MONOIDS["min"]
    assert resolve_monoid(MONOIDS["max"]) is MONOIDS["max"]
    with pytest.raises(ValueError, match="unknown combiner"):
        resolve_monoid("median")
    assert derive_monoid_for(torch.zeros(2, dtype=torch.bool)).name == "or"
    assert derive_monoid_for(torch.zeros(2)).name == "sum"
    assert derive_monoid_for(torch.zeros(2, dtype=torch.int32)).name == "sum"


# --------------------------------------------------------------------------
# HyperGraph
# --------------------------------------------------------------------------

def _pair(seed=0, with_mask=True):
    rng = np.random.default_rng(seed)
    nv, ne, nnz = 40, 25, 160
    src = rng.integers(0, nv, nnz).astype(np.int32)
    dst = rng.integers(0, ne, nnz).astype(np.int32)
    mask = (rng.random(nnz) > 0.2).astype(np.float32) if with_mask else None
    e_attr = rng.standard_normal(nnz).astype(np.float32)
    v_attr = rng.standard_normal((nv, 2)).astype(np.float32)
    jhg = JHyperGraph.from_coo(src, dst, nv, ne, e_mask=(
        jnp.asarray(mask) if mask is not None else None),
        e_attr=jnp.asarray(e_attr), v_attr=jnp.asarray(v_attr))
    thg = HyperGraph.from_numpy(src, dst, nv, ne, v_attr=v_attr,
                                e_attr=e_attr, e_mask=mask, device="cpu")
    return jhg, thg


def _assert_hg_equal(t, j):
    assert (t.n_vertices, t.n_hyperedges, t.nnz) == (
        j.n_vertices, j.n_hyperedges, j.nnz)
    assert t.src.dtype == torch.int32 and t.dst.dtype == torch.int32
    for a, b in ((t.src, j.src), (t.dst, j.dst)):
        assert _same(a, b)
    assert (t.e_mask is None) == (j.e_mask is None)
    if t.e_mask is not None:
        assert _same(t.e_mask, j.e_mask)
    for a, b in zip(tree_leaves(t.e_attr), tree_leaves(
            list(np.asarray(x) for x in ([j.e_attr] if j.e_attr is not None
                                         else [])))):
        assert _same(a, b)


@pytest.mark.parametrize("with_mask", [True, False])
def test_degrees_and_cardinalities(with_mask):
    jhg, thg = _pair(2, with_mask)
    assert _same(thg.degrees(), jhg.degrees())
    assert _same(thg.cardinalities(), jhg.cardinalities())


def test_padded_matches_reference():
    jhg, thg = _pair(3)
    _assert_hg_equal(thg.padded(48, 32, 200), jhg.padded(48, 32, 200))
    # the mask is always materialized, even at the same size
    jhg2, thg2 = _pair(3, with_mask=False)
    p = thg2.padded(40, 25, 160)
    assert p.e_mask is not None and p.e_mask.dtype == torch.float32
    _assert_hg_equal(p, jhg2.padded(40, 25, 160))
    assert _same(p.v_attr, jhg2.padded(40, 25, 160).v_attr)
    with pytest.raises(ValueError, match="must cover"):
        thg.padded(10, 25, 160)


def test_sorted_by_dst_and_sub_hypergraph_match_reference():
    jhg, thg = _pair(4)
    _assert_hg_equal(thg.sorted_by_dst(), jhg.sorted_by_dst())
    rng = np.random.default_rng(5)
    v_pred = rng.random(40) > 0.3
    he_pred = rng.random(25) > 0.3
    _assert_hg_equal(thg.sub_hypergraph(v_pred, he_pred),
                     jhg.sub_hypergraph(v_pred, he_pred))


def test_constructors_and_validate():
    edges = [[0, 1, 2], [2, 3], [], [4]]
    t = HyperGraph.from_hyperedge_lists(edges, device="cpu")
    j = JHyperGraph.from_hyperedge_lists(edges)
    _assert_hg_equal(t, j)
    t.validate()
    bad = HyperGraph.from_coo(np.array([0, 9]), np.array([0, 0]), 5, 1,
                              device="cpu")
    with pytest.raises(ValueError, match="vertex id out of range"):
        bad.validate()
    ids = t.map_vertices(lambda ids, _: ids * 2).v_attr
    assert ids.dtype == torch.int32 and ids.tolist() == [0, 2, 4, 6, 8]
    he = t.map_hyperedges(lambda ids, _: ids).he_attr
    assert he.dtype == torch.int32 and he.tolist() == [0, 1, 2, 3]


# --------------------------------------------------------------------------
# programming-model helpers
# --------------------------------------------------------------------------

def test_tree_map_and_leaves():
    tree = ProcedureOut(attr=(torch.ones(2), [torch.zeros(1)]),
                        msg={"a": torch.ones(3)}, active=None)
    doubled = tree_map(lambda x: x * 2, tree)
    assert isinstance(doubled, ProcedureOut) and doubled.active is None
    assert doubled.attr[0].tolist() == [2.0, 2.0]
    assert isinstance(doubled.attr[1], list)
    assert [x.numel() for x in tree_leaves(tree)] == [2, 1, 3]
    summed = tree_map(lambda x, y: x + y, (torch.ones(1), torch.ones(1)),
                      (torch.ones(1), torch.zeros(1)))
    assert [s.item() for s in summed] == [2.0, 1.0]


def test_initial_msg_identity_rows_and_monoid_for():
    msg = constant_initial_msg((torch.tensor(1.0), torch.tensor([2, 3])), 4)
    assert msg[0].shape == (4,) and msg[1].shape == (4, 2)
    assert msg[1][3].tolist() == [2, 3]
    rows = identity_rows(MONOIDS["min"], torch.zeros(5, 3, dtype=torch.int32),
                         4)
    assert rows.shape == (4, 3)
    assert (rows == np.iinfo(np.int32).max).all()
    prog = Program(procedure=None)
    assert prog.monoid_for(torch.zeros(1, dtype=torch.bool)).name == "or"
    assert Program(procedure=None, combiner="max").monoid_for(
        torch.zeros(1)).name == "max"


# --------------------------------------------------------------------------
# the generator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("regime,scale,seed", [
    ("dblp", 0.002, 0), ("apache", 0.05, 3), ("friendster", 0.0005, 1),
])
def test_make_dataset_matches_reference(regime, scale, seed):
    t = make_dataset(regime, scale, seed=seed, device="cpu")
    j = j_make_dataset(regime, scale, seed=seed)
    _assert_hg_equal(t, j)


def test_powerlaw_hypergraph_matches_reference():
    t = powerlaw_hypergraph(300, 200, mean_cardinality=6, seed=9,
                            device="cpu")
    j = j_powerlaw_hypergraph(300, 200, mean_cardinality=6, seed=9)
    _assert_hg_equal(t, j)
