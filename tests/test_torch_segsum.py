"""Parity of the port's segment-sum wrapper with the JAX package's, on
the CPU.

The port's ``segment_sum_mxu`` runs its kernels' plain versions here
(both forms: unsorted and ``sorted_dst=True``).  It is held against the
JAX package's ``segment_sum_mxu(..., interpret=True)`` (the Pallas
kernel in interpret mode) and its ``segment_sum_ref`` oracle on the same
numpy inputs from a seed, with the tolerance of ``tests/test_kernels.py``:
the ``(E, N, D)`` sweep in float32 and bfloat16, the sorted form, ids
outside ``[0, N)``, an empty input and a non-finite message (where the
port follows the oracle and the TPU kernel does not).  The card-only
tests of the kernels are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum.ops import segment_sum_mxu as j_segsum
from repro.kernels.segsum.ref import segment_sum_ref as j_ref
from repro_torch.kernels.segsum import (
    csr_row_offsets,
    segment_sum_mxu,
    segsum_cuda,
    segsum_plain,
    segsum_sorted_cuda,
    segsum_sorted_plain,
)

SWEEP = [(256, 64, 32), (1000, 300, 64), (512, 128, 128), (77, 13, 8),
         (2048, 17, 16)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(e, n, d, seed, *, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    dst = rng.integers(lo, n if hi is None else hi, e).astype(np.int32)
    return msgs, dst


def _port(msgs, dst, n, dtype, **kw):
    got = segment_sum_mxu(torch.as_tensor(msgs).to(DTYPES[dtype][0]),
                          torch.as_tensor(dst), n, **kw)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (n, msgs.shape[1])
    return got.float().numpy()


def _jax(fn, msgs, dst, n, dtype, **kw):
    return np.asarray(fn(jnp.asarray(msgs, DTYPES[dtype][1]),
                         jnp.asarray(dst), n, **kw), np.float32)


def _tol(e, n, dtype):
    """``tests/test_kernels.py``'s: bf16 rounding grows with the depth of
    a segment (~e/n addends), so the floor scales with its square root."""
    tol = 1e-5 if dtype == "float32" else 3e-2
    return dict(rtol=tol, atol=tol * 10 * max(1.0, (e / n) ** 0.5 / 3.0))


@pytest.mark.parametrize("e,n,d", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_sweep_matches_jax(e, n, d, dtype):
    msgs, dst = _inputs(e, n, d, e + n)
    got = _port(msgs, dst, n, dtype, block_n=64, block_e=128)
    tol = _tol(e, n, dtype)
    np.testing.assert_allclose(
        got, _jax(j_segsum, msgs, dst, n, dtype, block_n=64, block_e=128,
                  interpret=True), **tol)
    np.testing.assert_allclose(got, _jax(j_ref, msgs, dst, n, dtype), **tol)


@pytest.mark.parametrize("e,n,d", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_sorted_matches_jax_and_unsorted(e, n, d, dtype):
    """dst-sorted ids through the sorted form == the JAX package's sorted
    Pallas path and oracle, and, on the plain path, bitwise the unsorted
    form."""
    msgs, dst = _inputs(e, n, d, e * n)
    dst = np.sort(dst)
    got = _port(msgs, dst, n, dtype, sorted_dst=True, block_n=64,
                block_e=128)
    tol = _tol(e, n, dtype)
    np.testing.assert_allclose(
        got, _jax(j_segsum, msgs, dst, n, dtype, sorted_dst=True,
                  block_n=64, block_e=128, interpret=True), **tol)
    np.testing.assert_allclose(got, _jax(j_ref, msgs, dst, n, dtype), **tol)
    assert np.array_equal(got, _port(msgs, dst, n, dtype))


@pytest.mark.parametrize("sorted_dst", [False, True])
def test_segsum_drops_ids_outside_range(sorted_dst):
    """Negative ids and ids >= N (int32 and int64 beyond int32) are
    dropped, as by JAX's oracle and its unsorted Pallas path; nothing
    wraps into range.  JAX's sorted path drops ids >= N and raises on
    negative ones (its host-side ``np.bincount``)."""
    e, n, d = 600, 40, 8
    msgs, dst = _inputs(e, n, d, 11, lo=-6, hi=n + 6)
    if sorted_dst:
        dst = np.sort(dst)
    got = _port(msgs, dst, n, "float32", sorted_dst=sorted_dst,
                block_n=16, block_e=64)
    np.testing.assert_allclose(got, _jax(j_ref, msgs, dst, n, "float32"),
                               rtol=1e-5, atol=1e-5)
    pos = np.ones(e, bool)
    if sorted_dst:
        with pytest.raises(ValueError, match="negative"):
            _jax(j_segsum, msgs, dst, n, "float32", sorted_dst=True,
                 interpret=True)
        pos = dst >= 0
    np.testing.assert_allclose(
        got, _jax(j_segsum, msgs[pos], dst[pos], n, "float32",
                  sorted_dst=sorted_dst, block_n=16, block_e=64,
                  interpret=True),
        rtol=1e-5, atol=1e-5)
    keep = (dst >= 0) & (dst < n)
    assert np.array_equal(got, _port(msgs[keep], dst[keep], n, "float32"))
    wide = dst.astype(np.int64)
    wide[~keep] += np.where(wide[~keep] < 0, -2**32, 2**32)
    assert np.array_equal(got, _port(msgs, wide, n, "float32",
                                     sorted_dst=sorted_dst))


@pytest.mark.parametrize("sorted_dst", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_empty_input_gives_zeros(sorted_dst, dtype):
    """E = 0 gives zeros, as JAX's ``segment_sum_ref`` does (its Pallas
    path raises a TypeError on an empty input)."""
    msgs = np.zeros((0, 5), np.float32)
    dst = np.zeros(0, np.int32)
    got = _port(msgs, dst, 7, dtype, sorted_dst=sorted_dst)
    assert np.array_equal(got, _jax(j_ref, msgs, dst, 7, dtype))
    assert not got.any()


@pytest.mark.parametrize("sorted_dst", [False, True])
def test_segsum_nonfinite_message_stays_in_its_row(sorted_dst):
    """An infinite message stays in its own row, as in
    ``segment_sum_ref``.  The TPU kernel's one-hot product gives
    ``[nan, inf, nan]`` here (``0 * inf`` in the other rows of the tile):
    the documented divergence."""
    msgs = np.array([[1.0], [np.inf], [2.0], [3.0]], np.float32)
    dst = np.array([0, 1, 2, 70], np.int32)
    got = _port(msgs, dst, 3, "float32", sorted_dst=sorted_dst)
    assert np.array_equal(got.ravel(), [1.0, np.inf, 2.0])
    assert np.array_equal(got, _jax(j_ref, msgs, dst, 3, "float32"))
    tpu = _jax(j_segsum, msgs, dst, 3, "float32", sorted_dst=sorted_dst,
               interpret=True).ravel()
    assert np.isnan(tpu[[0, 2]]).all() and tpu[1] == np.inf


def test_segsum_sorted_rejects_unsorted_ids():
    msgs, dst = _inputs(100, 10, 4, 3)
    with pytest.raises(ValueError, match="non-decreasing"):
        segment_sum_mxu(torch.as_tensor(msgs), torch.as_tensor(dst), 10,
                        sorted_dst=True)
    with pytest.raises(AssertionError):
        j_segsum(jnp.asarray(msgs), jnp.asarray(dst), 10, sorted_dst=True,
                 interpret=True)


def test_segsum_rejects_other_types_and_shapes():
    dst = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        segment_sum_mxu(torch.zeros(4, 2, dtype=torch.float64), dst, 3)
    with pytest.raises(ValueError, match=r"\[E, D\]"):
        segment_sum_mxu(torch.zeros(4), dst, 3)
    with pytest.raises(ValueError, match="dst must be"):
        segment_sum_mxu(torch.zeros(4, 2), dst[:3], 3)


def test_segsum_cpu_takes_the_plain_versions():
    """On CPU tensors both wrappers run their plain versions, launch
    nothing, and the sorted plain version is bitwise the unsorted one on
    sorted ids."""
    before = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    msgs, dst = _inputs(700, 50, 6, 5)
    dst = np.sort(dst)
    m = torch.as_tensor(msgs).to(torch.bfloat16)
    ids = torch.as_tensor(dst)
    off = csr_row_offsets(ids, 50)
    for a, b in ((segsum_cuda(m, ids, 50), segsum_plain(m, ids, 50)),
                 (segsum_sorted_cuda(m, off, 50),
                  segsum_sorted_plain(m, off, 50)),
                 (segsum_sorted_plain(m, off, 50), segsum_plain(m, ids, 50))):
        assert torch.equal(a, b)
    segment_sum_mxu(m, ids, 50)
    segment_sum_mxu(m, ids, 50, sorted_dst=True)
    assert (segsum_cuda.launches, segsum_sorted_cuda.launches) == before
