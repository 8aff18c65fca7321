"""The port's copy of the neighbour sampler (``sparse.sampler``) against
the JAX package's: ``build_csr``, ``sample``, ``sample_padded`` and
``padded_block_shape`` bitwise equal over several seeds and fanouts, a
seed of in-degree 0 included, and the reference's own checks on the
port (``tests/test_sampler_clique.py``)."""
import dataclasses

import numpy as np
import pytest

import repro.sparse.sampler as jsampler
import repro_torch.sparse.sampler as tsampler
from repro_torch.sparse import NeighborSampler, SampledBlock, build_csr

FANOUTS = [(5, 3), (2,), (4, 4, 2), (1, 1)]


def _graph(n=500, e=4000, seed=0):
    """A random graph whose node ``n - 1`` has no in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 1, e).astype(np.int32)
    return src, dst, n


def _same_block(a, b):
    assert type(b).__name__ == type(a).__name__ == "SampledBlock"
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert a.n_nodes == b.n_nodes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_csr_bitwise(seed):
    src, dst, n = _graph(seed=seed)
    for got, want in zip(build_csr(src, dst, n),
                         jsampler.build_csr(src, dst, n)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_csr_toy_graph():
    src = np.array([1, 2, 2, 0], np.int32)
    dst = np.array([0, 0, 1, 3], np.int32)
    indptr, indices = build_csr(src, dst, 4)
    assert indptr.tolist() == [0, 2, 3, 3, 4]
    assert sorted(indices[0:2].tolist()) == [1, 2]
    assert indices[3] == 0


@pytest.mark.parametrize("fanouts", FANOUTS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_and_padded_bitwise(seed, fanouts):
    src, dst, n = _graph(seed=seed)
    indptr, indices = build_csr(src, dst, n)
    mine = NeighborSampler(indptr, indices, fanouts=fanouts, seed=seed)
    ref = jsampler.NeighborSampler(indptr, indices, fanouts=fanouts,
                                   seed=seed)
    rng = np.random.default_rng(100 + seed)
    for batch in (8, 3, 16):
        seeds = rng.integers(0, n, batch).astype(np.int32)
        seeds[0] = n - 1                      # in-degree 0
        assert mine.padded_block_shape(batch) == ref.padded_block_shape(
            batch)
        _same_block(mine.sample(seeds), ref.sample(seeds))
        _same_block(mine.sample_padded(seeds), ref.sample_padded(seeds))


def test_zero_degree_seed_masks_its_edges():
    src, dst, n = _graph()
    indptr, indices = build_csr(src, dst, n)
    sampler = NeighborSampler(indptr, indices, fanouts=(3,), seed=0)
    block = sampler.sample(np.array([n - 1, 0], np.int32))
    assert block.nodes[0] == n - 1
    assert block.edge_mask[:3].tolist() == [0.0, 0.0, 0.0]
    assert block.edge_mask[3:].tolist() == [1.0, 1.0, 1.0]


def test_sampler_static_shapes_and_validity():
    rng = np.random.default_rng(0)
    n = 500
    src = rng.integers(0, n, 4000).astype(np.int32)
    dst = rng.integers(0, n, 4000).astype(np.int32)
    indptr, indices = build_csr(src, dst, n)
    sampler = NeighborSampler(indptr, indices, fanouts=(5, 3), seed=1)
    n_nodes_max, n_edges_max = sampler.padded_block_shape(8)
    for _ in range(3):
        seeds = rng.integers(0, n, 8).astype(np.int32)
        block = sampler.sample_padded(seeds)
        assert isinstance(block, SampledBlock)
        assert block.nodes.shape == (n_nodes_max + 1,)
        assert block.edge_src.shape == (n_edges_max,)
        assert block.edge_dst.shape == (n_edges_max,)
        live = block.edge_mask > 0
        # every live edge's endpoints are real block nodes
        assert block.edge_src[live].max() < n_nodes_max
        assert block.seed_count == 8
        assert np.array_equal(np.unique(block.nodes[:8]),
                              np.unique(seeds)) or len(np.unique(seeds)) < 8


def test_the_port_imports_no_jax():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tsampler))
    names = {a.name for node in ast.walk(tree)
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in node.names}
    mods = {node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom)}
    assert not any(n.startswith(("jax", "repro.")) or n == "repro"
                   for n in names | {m for m in mods if m})
