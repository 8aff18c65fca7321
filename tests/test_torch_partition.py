"""Partition plans, the design axes that read them, and the per-shard
fused layouts of the port, held against the JAX package on the CPU
(no process group needed):

* every strategy of ``STRATEGIES`` gives the reference's plan bitwise:
  ``edge_part``, the padded shards, ``shard_len`` and every stats field;
* ``select_partition``, ``select_backend`` and ``state_width_bytes``
  give the reference's values and reasons;
* ``build_shard_delivery`` at P = 4 on Apache 0.04 gives each shard
  the reference's stacked layout arrays, array by array, with the
  harmonised statics;
* K1's plain version (``deliver_leaf_cuda`` on CPU tensors) and the
  CPU's sliced-ELL lowering over the four shard layouts, combined with
  the monoid, equal the local delivery: zero-degree destinations of a
  shard come out as the identity.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.executor as jexec
from repro.core.distributed import build_shard_delivery as j_shard_delivery
from repro.data import make_dataset as j_make
from repro.data import powerlaw_hypergraph as j_powerlaw
from repro.partition import STRATEGIES as J_STRATEGIES
from repro.partition import partition as j_partition
import repro_torch.core.executor as texec
from repro_torch.core import HyperGraph, deliver
from repro_torch.core.api import Program
from repro_torch.core.distributed import build_shard_delivery
from repro_torch.kernels.deliver import deliver_leaf_cuda, fused_deliver
from repro_torch.partition import STRATEGIES, partition
from repro_torch.sparse.segment import MONOIDS

GRAPHS = {
    "apache": (lambda: j_make("apache", 0.04, seed=3), 4),
    "powerlaw": (lambda: j_powerlaw(150, 90, mean_cardinality=4,
                                    max_cardinality=120, seed=5), 3),
}
_CACHE = {}


def _graphs(name):
    if name not in _CACHE:
        make, parts = GRAPHS[name]
        jhg = make()
        thg = HyperGraph.from_numpy(jhg.src, jhg.dst, jhg.n_vertices,
                                    jhg.n_hyperedges, device="cpu")
        _CACHE[name] = (jhg, thg, parts)
    return _CACHE[name]


def _same_plan(got, want):
    assert got.name == want.name and got.n_parts == want.n_parts
    for f in ("edge_part", "shard_src", "shard_dst", "shard_mask"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.shard_len == want.shard_len
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def test_strategy_registry_matches_jax():
    assert sorted(STRATEGIES) == sorted(J_STRATEGIES)


CASES = [(name, {}) for name in sorted(J_STRATEGIES)] + [
    (name, {"chunk": 32}) for name in sorted(J_STRATEGIES) if "greedy" in name]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("strategy,kw", CASES,
                         ids=[n + ("-chunk32" if kw else "")
                              for n, kw in CASES])
def test_partition_is_bitwise_the_reference(graph, strategy, kw):
    jhg, thg, parts = _graphs(graph)
    _same_plan(partition(strategy, thg, parts, **kw),
               j_partition(strategy, jhg, parts, **kw))


def test_partition_rejects_what_the_reference_rejects():
    jhg, thg, _ = _graphs("powerlaw")
    for fn, hg in ((j_partition, jhg), (partition, thg)):
        with pytest.raises(ValueError, match="uint64 bitmask"):
            fn("greedy_vertex_cut", hg, 65)


@pytest.mark.parametrize("strategy", ["auto", "hybrid_vertex_cut",
                                      "greedy_hyperedge_cut"])
def test_select_partition_matches_jax(strategy):
    jhg, thg, parts = _graphs("apache")
    tplan, twhy = texec.select_partition(thg, parts, strategy)
    jplan, jwhy = jexec.select_partition(jhg, parts, strategy)
    _same_plan(tplan, jplan)
    assert twhy == jwhy


def test_select_partition_unknown_strategy_message():
    jhg, thg, _ = _graphs("powerlaw")
    msgs = []
    for fn, hg in ((jexec.select_partition, jhg),
                   (texec.select_partition, thg)):
        with pytest.raises(ValueError) as err:
            fn(hg, 2, "metis")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "unknown partition strategy" in msgs[0]


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("widths", [(4.0, 4.0), (4.0, 256.0), (64.0, 1.0)])
@pytest.mark.parametrize("bias", [0.5, 0.05])
def test_select_backend_matches_jax(parts, widths, bias):
    jhg, thg, _ = _graphs("apache")
    plan = partition("random_vertex_cut", thg, parts)
    jplan = j_partition("random_vertex_cut", jhg, parts)
    kw = dict(replicated_bias=bias, v_state_bytes=widths[0],
              he_state_bytes=widths[1])
    assert texec.select_backend(plan, thg.n_vertices, thg.n_hyperedges,
                                **kw) == \
        jexec.select_backend(jplan, jhg.n_vertices, jhg.n_hyperedges, **kw)


def test_state_width_bytes_matches_jax():
    import jax.numpy as jnp

    cases = [
        None,
        np.zeros((10, 3), np.float32),
        (np.zeros(10, np.float32), np.zeros((10, 4), np.int32)),
        {"a": np.zeros((10, 2), np.float32), "b": np.zeros(10, np.bool_)},
    ]
    for tree in cases:
        tt = None if tree is None else (
            torch.as_tensor(tree) if isinstance(tree, np.ndarray) else
            type(tree)(torch.as_tensor(x) for x in tree)
            if isinstance(tree, tuple) else
            {k: torch.as_tensor(v) for k, v in tree.items()})
        jt = None if tree is None else (
            jnp.asarray(tree) if isinstance(tree, np.ndarray) else
            tuple(jnp.asarray(x) for x in tree)
            if isinstance(tree, tuple) else
            {k: jnp.asarray(v) for k, v in tree.items()})
        for n in (10, 0):
            assert texec.state_width_bytes(tt, n) == \
                jexec.state_width_bytes(jt, n)


@pytest.fixture(scope="module")
def shard_layouts():
    jhg, thg, _ = _graphs("apache")
    plan = partition("random_vertex_cut", thg, 4)
    nv_pad = -(-thg.n_vertices // 4) * 4
    ne_pad = -(-thg.n_hyperedges // 4) * 4
    got = build_shard_delivery(plan.shard_src, plan.shard_dst,
                               plan.shard_mask, nv_pad, ne_pad)
    want = j_shard_delivery(plan.shard_src, plan.shard_dst, plan.shard_mask,
                            nv_pad, ne_pad)
    return thg, plan, got, want


ARRAYS = ("class_ell", "class_src", "class_dst", "class_bounds")
STATICS = ("n_src", "n_dst", "nnz", "rem_nnz", "class_widths", "class_rows",
           "block_n", "class_block_e", "class_max_blocks")


@pytest.mark.parametrize("shard", range(4))
@pytest.mark.parametrize("direction", [0, 1], ids=["fwd", "bwd"])
def test_shard_layouts_equal_the_reference(shard_layouts, shard, direction):
    _, _, got, want = shard_layouts
    mine, ref = got[shard][direction], want[direction]
    for f in ARRAYS:
        for c, arr in enumerate(getattr(mine, f)):
            b = np.asarray(getattr(ref, f)[c][shard])
            assert np.array_equal(arr.numpy(), b), (f, c)
    for f in ("inv_perm", "rem_src", "rem_dst"):
        assert np.array_equal(getattr(mine, f).numpy(),
                              np.asarray(getattr(ref, f)[shard])), f
    for f in STATICS:
        assert getattr(mine, f) == getattr(ref, f), f


def test_shard_layouts_share_one_shape(shard_layouts):
    _, _, got, _ = shard_layouts
    for direction in (0, 1):
        shapes = {tuple(tuple(t.shape) for t in lay[direction].tensors())
                  for lay in got}
        assert len(shapes) == 1
    one = build_shard_delivery(*(getattr(shard_layouts[1], f) for f in (
        "shard_src", "shard_dst", "shard_mask")),
        got[0][0].n_src, got[0][0].n_dst, parts=(2,))
    for a, b in zip(one[0][0].tensors(), got[2][0].tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("monoid", ["sum", "min", "max", "or"])
@pytest.mark.parametrize("lowering", ["k1_plain", "ell"])
def test_shard_partials_combine_to_the_local_delivery(shard_layouts, monoid,
                                                      lowering):
    thg, plan, got, _ = shard_layouts
    nv_pad, ne_pad = got[0][0].n_src, got[0][0].n_dst
    rng = np.random.default_rng(7)
    if monoid == "or":
        msgs = torch.as_tensor(rng.random((nv_pad, 2)) < 0.3)
    elif monoid == "sum":
        msgs = torch.as_tensor(rng.standard_normal((nv_pad, 2))
                               .astype(np.float32))
    else:
        msgs = torch.as_tensor(rng.integers(-50, 50, (nv_pad, 2))
                               .astype(np.int32))
    active = torch.as_tensor(rng.random(nv_pad) < 0.8)
    prog = Program(procedure=None, combiner=monoid)
    mono = MONOIDS[monoid]
    parts = []
    for fwd, _ in got:
        if lowering == "ell":
            parts.append(fused_deliver(msgs, active, fwd, prog))
        elif monoid == "or":
            parts.append(deliver_leaf_cuda(msgs.to(torch.int32), active,
                                           fwd, "max") > 0)
        else:
            parts.append(deliver_leaf_cuda(msgs, active, fwd, monoid))
    total = parts[0]
    for p in parts[1:]:
        total = mono.combine(total, p)
    src = torch.as_tensor(plan.shard_src.reshape(-1))
    dst = torch.as_tensor(plan.shard_dst.reshape(-1))
    mask = torch.as_tensor(plan.shard_mask.reshape(-1))
    local = deliver(msgs, active, src, dst, ne_pad, prog, e_mask=mask)
    if monoid == "sum":
        assert torch.allclose(total, local, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(total, local)
    # a destination no live edge of a shard reaches is the identity there
    for p, part in enumerate(parts):
        reached = np.zeros(ne_pad, bool)
        reached[plan.shard_dst[p][plan.shard_mask[p] != 0]] = True
        ident = mono.identity(part.dtype)
        assert (part[torch.as_tensor(~reached)] == ident).all()
