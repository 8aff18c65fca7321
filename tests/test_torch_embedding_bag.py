"""``sparse.embedding_bag`` in the port against the JAX package's, on
the same numpy tables and ids: ``sum`` (K2a's plain version here,
through ``SegmentSumFn``), ``mean`` and ``max``, with and without
per-sample weights, bags in any order with empty ones and dropped ids;
the dense variant with and without ``pad_id``; the sum's gradient
through ``SegmentSumFn`` against ``jax.grad``; an empty bag's max (0);
``EmbeddingBagSpec``."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.sparse.segment as tseg
from repro_torch.kernels.segsum import SegmentSumFn
from repro_torch.sparse import EmbeddingBagSpec, embedding_bag
from repro_torch.sparse.embedding_bag import embedding_bag_dense

# ``repro.sparse.embedding_bag`` as an attribute is the function.
jeb = importlib.import_module("repro.sparse.embedding_bag")
MODES = ("sum", "mean", "max")
TOL = dict(rtol=1e-5, atol=1e-5)
# (vocab, dim, nnz, num_bags, sorted bags): tests/test_segment_ops.py's
# ranges and BERT4Rec's row width.
CASES = [(20, 8, 30, 4, True), (2, 1, 1, 4, False), (50, 64, 200, 7, False),
         (1000, 16, 500, 33, False), (7, 3, 12, 12, True)]


def _inputs(vocab, dim, nnz, num_bags, sorted_bags, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((vocab, dim)).astype(np.float32)
    idx = rng.integers(0, vocab, nnz).astype(np.int32)
    bags = rng.integers(0, num_bags, nnz).astype(np.int32)
    if sorted_bags:
        bags = np.sort(bags)
    weights = rng.uniform(0.5, 2.0, nnz).astype(np.float32)
    return table, idx, bags, weights


@pytest.fixture
def count_k2a(monkeypatch):
    """Counts ``SegmentSumFn`` calls made by the segment ops."""
    calls = []

    class Counted(SegmentSumFn):
        @staticmethod
        def forward(ctx, msgs, dst, n):
            calls.append(tuple(msgs.shape))
            return SegmentSumFn.forward(ctx, msgs, dst, n)

    monkeypatch.setattr(tseg, "SegmentSumFn", Counted)
    return calls


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_embedding_bag_matches_jax(case, mode, weighted, count_k2a):
    table, idx, bags, w = _inputs(*case)
    num_bags = case[3]
    want = jeb.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                             jnp.asarray(bags), num_bags, mode=mode,
                             weights=jnp.asarray(w) if weighted else None)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(bags), num_bags, mode=mode,
                        weights=torch.from_numpy(w) if weighted else None)
    assert got.shape == (num_bags, case[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # sum and mean run K2a's route (its plain version on the CPU); max
    # takes the scatter.
    assert len(count_k2a) == (0 if mode == "max" else 1)


@pytest.mark.parametrize("mode", MODES)
def test_dropped_and_unknown_ids_as_jax(mode):
    """Bag ids outside ``[0, num_bags)`` are dropped and row ids outside
    ``[-V, V)`` read NaN rows, as ``jnp.take`` and the segment ops do;
    negative row ids count from the end."""
    table, idx, bags, _ = _inputs(30, 4, 40, 5, False, seed=3)
    bags[:3] = [-1, 5, 9]
    idx[10:13] = [-1, -30, 29]
    idx[20] = 31                    # a NaN row, in bag bags[20]
    want = np.asarray(jeb.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(bags), 5,
        mode=mode))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        torch.from_numpy(bags), 5, mode=mode).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_empty_bag_max_is_zero():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) - 20.0
    out = embedding_bag(table, torch.tensor([1, 2, 3]),
                        torch.tensor([0, 0, 2]), 4, mode="max")
    assert torch.equal(out[1], torch.zeros(3))
    assert torch.equal(out[3], torch.zeros(3))
    assert torch.equal(out[0], table[2])     # all negative rows
    assert torch.equal(out[2], table[3])


@pytest.mark.parametrize("pad_id", [None, 0, 3])
@pytest.mark.parametrize("mode", MODES)
def test_embedding_bag_dense_matches_jax(mode, pad_id):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    idx = rng.integers(1, 50, (6, 5)).astype(np.int32)
    idx[2, 3:] = 0
    idx[4, :] = 0                       # a bag of pads only
    idx[5, 1] = 3
    want = jeb.embedding_bag_dense(jnp.asarray(table), jnp.asarray(idx),
                                   mode=mode, pad_id=pad_id)
    got = embedding_bag_dense(torch.from_numpy(table),
                              torch.from_numpy(idx), mode=mode,
                              pad_id=pad_id)
    assert got.shape == (6, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_equals_ragged_without_pads():
    """``tests/test_segment_ops.py``'s rule in the port: the dense sum
    with ``pad_id`` is the ragged sum over the kept ids."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(1, 50, (6, 5)).astype(np.int64))
    idx[2, 3:] = 0
    dense = embedding_bag_dense(table, idx, mode="sum", pad_id=0)
    flat = idx.reshape(-1)
    bags = torch.arange(6).repeat_interleave(5)
    keep = flat != 0
    ragged = embedding_bag(table, flat[keep], bags[keep], 6, mode="sum")
    torch.testing.assert_close(dense, ragged, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_gradient_through_segment_sum_fn(mode, weighted, count_k2a):
    table, idx, bags, w = _inputs(40, 16, 120, 9, False, seed=7)
    cot = np.random.default_rng(8).standard_normal((9, 16)).astype(
        np.float32)

    def jloss(t, wt):
        out = jeb.embedding_bag(t, jnp.asarray(idx), jnp.asarray(bags), 9,
                                mode=mode, weights=wt if weighted else None)
        return jnp.sum(out * cot)

    want_t, want_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                                    jnp.asarray(w))
    t = torch.from_numpy(table).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = embedding_bag(t, torch.from_numpy(idx), torch.from_numpy(bags), 9,
                        mode=mode, weights=wt if weighted else None)
    (out * torch.from_numpy(cot)).sum().backward()
    assert count_k2a == [(120, 16)]
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t), **TOL)
    if weighted:
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w),
                                   **TOL)


def test_spec_fields_and_init():
    want = [f.name for f in dataclasses.fields(jeb.EmbeddingBagSpec)]
    assert [f.name for f in dataclasses.fields(EmbeddingBagSpec)] == want
    spec = EmbeddingBagSpec(vocab_size=4096, dim=64)
    assert (spec.mode, spec.dtype) == ("sum", torch.float32)
    t = spec.init(torch.Generator().manual_seed(0))
    assert t.shape == (4096, 64) and t.dtype == torch.float32
    assert abs(float(t.std()) - 64**-0.5) < 0.01
    again = spec.init(torch.Generator().manual_seed(0))
    assert torch.equal(t, again)
    bf = dataclasses.replace(spec, dtype=torch.bfloat16).init(
        torch.Generator().manual_seed(0))
    assert bf.dtype == torch.bfloat16
