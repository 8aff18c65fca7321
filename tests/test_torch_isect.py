"""Parity of the port's bitset intersection kernel wrapper with the JAX
package's, on the CPU.

The port's ``pair_intersect_bitset`` (both forms: rows gathered in the
kernel, ``fused=True``, and pre-gathered, ``fused=False``) runs its
plain torch version here.  It is held, with exact equality, against the
JAX package's ``pair_intersect_bitset(..., interpret=True)`` (the Pallas
kernel in interpret mode) and the port's ``pair_intersect_ref`` oracle,
itself held against the JAX package's ``pair_intersect_ref``, on the
same numpy inputs from a seed: a sweep of (pairs, edges, vertices) with
word counts that are and are not multiples of 4 or 8, words with bit 31
set, skewed hot rows, self pairs, an empty batch, triples against JAX's
``batch_intersections`` and the ``pair_index_from_numpy`` round trip.
The card-only tests of the kernel itself are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import powerlaw_hypergraph as j_powerlaw
from repro.kernels.isect.ops import pair_intersect_bitset as j_isect
from repro.kernels.isect.ref import pair_intersect_ref as j_isect_ref
from repro.motifs import batch_intersections as j_batch
from repro.motifs import build_index as j_build_index
from repro_torch.kernels.isect import (
    isect_cuda,
    isect_fused_cuda,
    isect_fused_plain,
    isect_plain,
    pair_intersect_bitset,
    pair_intersect_ref,
    popcount_words,
)
from repro_torch.motifs import batch_intersections, pair_index_from_numpy


def _bits(n_vertices, n_edges, seed):
    """A JAX bitset index (uint32) and its numpy copy."""
    hg = j_powerlaw(n_vertices, n_edges, mean_cardinality=4, seed=seed)
    data = j_build_index(hg, "bitset").data
    return data, np.asarray(data)


def _port(bits_np, ea, eb, ec=None, **kw):
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32))
    got = pair_intersect_bitset(
        torch.as_tensor(bits_np.view(np.int32).copy()), t(ea), t(eb),
        None if ec is None else t(ec), **kw)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy()


def _oracle(bits_np, ea, eb):
    """The port's oracle on the numpy inputs, held against the JAX
    package's oracle on the same inputs (exact)."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32))
    got = pair_intersect_ref(torch.as_tensor(bits_np.view(np.int32).copy()),
                             t(ea), t(eb))
    assert got.dtype == torch.int32
    want = np.asarray(j_isect_ref(jnp.asarray(bits_np), jnp.asarray(ea),
                                  jnp.asarray(eb)))
    assert np.array_equal(got.numpy(), want)
    return got.numpy()


def _set_sizes(bits_np, ea, eb):
    """Python-int popcount of each pair's AND: the plainest oracle."""
    return np.array([sum(bin(int(x) & int(y)).count("1")
                         for x, y in zip(bits_np[a], bits_np[b]))
                     for a, b in zip(ea, eb)], np.int32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n_pairs,n_edges,n_vertices", [
    (100, 40, 64), (1000, 300, 500), (37, 5, 2000), (513, 64, 31),
    (300, 70, 3316), (257, 50, 3232), (129, 33, 200),
])
def test_isect_sweep_matches_jax(n_pairs, n_edges, n_vertices, fused):
    """W = 2, 16, 63, 1, 104, 101, 7 words."""
    bits, bits_np = _bits(n_vertices, n_edges, n_pairs + n_edges)
    rng = np.random.default_rng(n_pairs)
    ea = rng.integers(0, n_edges, n_pairs).astype(np.int32)
    eb = rng.integers(0, n_edges, n_pairs).astype(np.int32)
    got = _port(bits_np, ea, eb, fused=fused, tile=96)
    want = np.asarray(j_isect(bits, jnp.asarray(ea), jnp.asarray(eb),
                              block_p=128, block_w=4, fused=fused,
                              interpret=True))
    ref = _oracle(bits_np, ea, eb)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("word", [0xFFFFFFFF, 0x80000000, 0x80000001,
                                  0x7FFFFFFF])
def test_isect_words_with_bit_31(word):
    """An int32 view of these words is negative: the plain version's
    popcount must count the sign bit once and not smear it."""
    rng = np.random.default_rng(word & 0xFFFF)
    bits_np = rng.integers(0, 2**32, (20, 9), dtype=np.uint64).astype(
        np.uint32)
    bits_np[::2, ::3] = word
    bits_np[3] = word
    ea = rng.integers(0, 20, 200).astype(np.int32)
    eb = rng.integers(0, 20, 200).astype(np.int32)
    ea[:20] = 3
    want = _oracle(bits_np, ea, eb)
    assert np.array_equal(want, _set_sizes(bits_np, ea, eb))
    for fused in (True, False):
        assert np.array_equal(_port(bits_np, ea, eb, fused=fused), want)
    words = torch.as_tensor(bits_np.view(np.int32))
    pc = popcount_words(words).numpy()
    assert np.array_equal(
        pc, np.vectorize(lambda x: bin(int(x)).count("1"))(bits_np))


def test_isect_skewed_hot_rows_and_self_pairs():
    bits, bits_np = _bits(300, 64, 9)
    ea = np.zeros(700, np.int32)                  # one hot row vs all
    eb = (np.arange(700) % 64).astype(np.int32)
    want = np.asarray(j_isect(bits, jnp.asarray(ea), jnp.asarray(eb),
                              block_p=128, block_w=4, fused=True,
                              interpret=True))
    for fused in (True, False):
        assert np.array_equal(_port(bits_np, ea, eb, fused=fused), want)
    # a Zipf-skewed batch: a few rows repeat many times
    rng = np.random.default_rng(1)
    ea = ((rng.zipf(1.3, 900) - 1) % 64).astype(np.int32)
    eb = ((rng.zipf(1.3, 900) - 1) % 64).astype(np.int32)
    assert np.array_equal(_port(bits_np, ea, eb),
                          _oracle(bits_np, ea, eb))
    # e ∩ e == |e|
    ids = np.arange(64, dtype=np.int32)
    card = np.asarray(j_build_index(
        j_powerlaw(300, 64, mean_cardinality=4, seed=9), "bitset"
    ).cardinalities())
    for fused in (True, False):
        assert np.array_equal(_port(bits_np, ids, ids, fused=fused), card)
    t = torch.as_tensor(bits_np.view(np.int32).copy())
    assert np.array_equal(isect_cuda(t, t).numpy(), card)


def test_isect_empty_batch():
    _, bits_np = _bits(50, 10, 0)
    for fused in (True, False):
        got = _port(bits_np, np.zeros(0, np.int32), np.zeros(0, np.int32),
                    fused=fused)
        assert got.shape == (0,)
    empty = torch.zeros((0, 3), dtype=torch.int32)
    assert isect_plain(empty, empty).shape == (0,)


@pytest.mark.parametrize("kind", ["bitset", "merge"])
def test_triples_match_jax_batch_intersections(kind):
    hg = j_powerlaw(400, 120, mean_cardinality=6, seed=4)
    index = j_build_index(hg, kind)
    port = pair_index_from_numpy(kind, index.n_vertices, index.n_hyperedges,
                                 np.asarray(index.data))
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(0, 120, 1000) for _ in range(3))
    got = batch_intersections(port, a, b, c, tile=300)
    want = j_batch(index, a, b, c, tile=256)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if kind == "bitset":
        bits_np = np.asarray(index.data)
        assert np.array_equal(_port(bits_np, a, b, c), want)
        fused = isect_fused_plain(port.data, *(torch.as_tensor(
            x.astype(np.int32)) for x in (a, b, c)), tile=77)
        assert np.array_equal(fused.numpy(), want)


def test_pair_index_from_numpy_round_trip():
    hg = j_powerlaw(100, 30, mean_cardinality=4, seed=3)
    for kind in ("bitset", "merge"):
        index = j_build_index(hg, kind)
        data = np.asarray(index.data)
        port = pair_index_from_numpy(kind, index.n_vertices,
                                     index.n_hyperedges, data)
        assert port.data.dtype == torch.int32
        assert np.array_equal(port.data.numpy().view(data.dtype), data)
        assert (port.width, port.nbytes) == (index.width, index.nbytes)
        assert np.array_equal(port.cardinalities(), index.cardinalities())
    with pytest.raises(TypeError, match="uint32 or int32"):
        pair_index_from_numpy("bitset", 1, 1, np.zeros((2, 2), np.float32))


def test_wrappers_keep_cpu_and_refuse_other_devices():
    """A CPU tensor takes the plain version; a tensor elsewhere launches
    the kernel or raises, and never falls back to the plain version."""
    bits = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no intersection kernel"):
        isect_fused_cuda(bits, ids, ids)
    with pytest.raises(ValueError, match="no intersection kernel"):
        isect_cuda(bits, bits)
    cpu_ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes pairs"):
        pair_intersect_bitset(torch.zeros((4, 2), dtype=torch.int32),
                              cpu_ids, cpu_ids, cpu_ids, fused=False)
