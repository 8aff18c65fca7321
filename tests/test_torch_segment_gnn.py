"""Parity of the GNN side's message-passing reductions with the JAX
package, on the CPU.

The same numpy inputs from a seed go through ``repro.sparse.segment``
and ``repro_torch.sparse.segment``:

* ``mp_segment_sum`` (rows of rank 1-3, ids outside ``[0, N)``, empty
  segments) within 1e-5 relative; ``mp_segment_max`` / ``_min`` and
  ``segment_count`` bitwise (``-inf`` / ``inf`` in empty segments);
* ``segment_mean``, ``segment_softmax`` (GAT's ``-1e30`` masked logits
  and empty segments, no NaN), ``segment_logsumexp``,
  ``segment_normalize`` and ``segment_std`` on spread-out values;
* ``segment_std`` against a float64 numpy reference on the cancelling
  case (values near 50-100 with a spread of 0.01), where the JAX
  package's one-pass float32 E[x²] − E[x]² is off by orders of
  magnitude and the port's two passes are not;
* gradients of max / min with ties (the cotangent split evenly among
  the tied rows, as JAX's scatter gradient splits it) and of the softmax;
* K2's autograd function (``SegmentSumFn``: the CPU runs K2a's plain
  version) against the scatter's forward and gradient.

Tolerances: float32 sums reassociate (1e-5 relative to the largest
magnitude); max / min / count and tie gradients are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse.segment as jseg
import repro_torch.sparse.segment as tseg
from repro_torch.kernels.segsum import SegmentSumFn

N = 13


def _ids(rng, e, n=N, out_of_range=True):
    ids = rng.integers(0, n - 3, e).astype(np.int32)   # the last 3 empty
    if out_of_range:
        ids[::7] = n + 2
        ids[3::11] = -1
    return ids


def _rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("shape", [(), (5,), (4, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mp_segment_sum_matches_the_reference(shape, seed):
    rng = np.random.default_rng(seed)
    e = 200
    x = rng.standard_normal((e,) + shape).astype(np.float32)
    ids = _ids(rng, e)
    want = jseg.mp_segment_sum(jnp.asarray(x), jnp.asarray(ids), N)
    got = tseg.mp_segment_sum(_t(x), _t(ids), N)
    assert got.dtype == torch.float32 and got.shape == (N,) + shape
    assert _rel(got, want) <= 1e-5
    assert not got[-3:].any()                           # empty segments


def test_mp_segment_sum_bfloat16_sums_in_float32():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 6)).astype(np.float32)
    ids = _ids(rng, 300)
    xb = _t(x).to(torch.bfloat16)
    got = tseg.mp_segment_sum(xb, _t(ids), N)
    want = tseg.mp_segment_sum(xb.float(), _t(ids), N).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("name", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mp_segment_max_min_bitwise(name, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (150, 4)).astype(np.float32)   # many ties
    x[5] = np.nan if seed == 2 else x[5]
    ids = _ids(rng, 150)
    want = getattr(jseg, f"mp_segment_{name}")(jnp.asarray(x),
                                               jnp.asarray(ids), N)
    got = getattr(tseg, f"mp_segment_{name}")(_t(x), _t(ids), N)
    assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
    assert np.isinf(got[-3:].numpy()).all()


def test_segment_count_bitwise():
    rng = np.random.default_rng(4)
    ids = _ids(rng, 500)
    want = np.asarray(jseg.segment_count(jnp.asarray(ids), N))
    got = tseg.segment_count(_t(ids), N)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", ["segment_mean", "segment_std",
                                "segment_softmax", "segment_logsumexp",
                                "segment_normalize"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_statistics_match_the_reference(fn, seed):
    """Spread-out values (no cancellation), ids out of range too."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((240, 3)) * 3).astype(np.float32)
    if fn == "segment_normalize":
        x = np.abs(x) + 0.1
    ids = _ids(rng, 240)
    want = getattr(jseg, fn)(jnp.asarray(x), jnp.asarray(ids), N)
    got = getattr(tseg, fn)(_t(x), _t(ids), N)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-5


def test_segment_softmax_masked_logits_and_empty_segments():
    """GAT's masked edges carry ``-1e30``; a segment of only masked edges
    and the empty ones give the reference's numbers and no NaN."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((90, 4)).astype(np.float32)
    ids = rng.integers(0, 8, 90).astype(np.int32)       # 8..12 empty
    logits[ids == 2] = -1e30                             # all masked
    logits[::5] = -1e30
    want = jseg.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), N)
    got = tseg.segment_softmax(_t(logits), _t(ids), N)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-5
    x = _t(logits).requires_grad_(True)
    w = rng.standard_normal((90, 4)).astype(np.float32)
    (tseg.segment_softmax(x, _t(ids), N) * _t(w)).sum().backward()
    jg = jax.grad(lambda v: (jseg.segment_softmax(v, jnp.asarray(ids), N)
                             * w).sum())(jnp.asarray(logits))
    assert torch.isfinite(x.grad).all()
    assert _rel(x.grad, jg) <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_std_cancelling_case_against_float64(seed):
    """Values near 50-100 with a spread of 0.01: the port's two passes
    hold the float64 numpy std to 1e-4 relative; the JAX package's one
    pass is printed beside it and is not held to anything."""
    rng = np.random.default_rng(seed)
    n_seg, e = 6, 400
    ids = rng.integers(0, n_seg, e).astype(np.int32)
    centre = rng.uniform(50, 100, n_seg)
    x = (centre[ids] + rng.standard_normal(e) * 0.01).astype(np.float32)
    want = np.array([np.sqrt(x[ids == s].astype(np.float64).var() + 1e-5)
                     for s in range(n_seg)])
    got = tseg.segment_std(_t(x), _t(ids), n_seg).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ref = np.asarray(jseg.segment_std(jnp.asarray(x), jnp.asarray(ids),
                                      n_seg), np.float64)
    print("reference one-pass rel err", np.abs(ref - want).max() / want.max())


@pytest.mark.parametrize("name", ["max", "min"])
def test_max_min_gradients_split_ties_as_the_reference(name):
    rng = np.random.default_rng(6)
    x = rng.integers(-2, 3, (120, 3)).astype(np.float32)   # ties
    ids = _ids(rng, 120)
    w = rng.standard_normal((N, 3)).astype(np.float32)
    jf = getattr(jseg, f"mp_segment_{name}")
    want = jax.grad(lambda v: jnp.sum(
        jnp.where(jnp.isfinite(jf(v, jnp.asarray(ids), N)),
                  jf(v, jnp.asarray(ids), N), 0.0) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = getattr(tseg, f"mp_segment_{name}")(xt, _t(ids), N)
    (torch.where(torch.isfinite(out), out, 0.0) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("d", [1, 8, 47, 64])
def test_k2_autograd_function_equals_the_scatter(d):
    """``SegmentSumFn`` (K2a's plain version here) against the scatter's
    sum, forward and gradient, with ids outside ``[0, N)``."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((500, d)).astype(np.float32)
    ids = _ids(rng, 500)
    g = rng.standard_normal((N, d)).astype(np.float32)
    a = _t(x).requires_grad_(True)
    b = _t(x).requires_grad_(True)
    got = SegmentSumFn.apply(a, _t(ids), N)
    want = tseg.MONOIDS["sum"].segment(b, _t(ids), N)
    assert _rel(got, want.detach()) <= 1e-6
    (got * _t(g)).sum().backward()
    (want * _t(g)).sum().backward()
    assert torch.equal(a.grad, b.grad)
    dropped = (ids < 0) | (ids >= N)
    assert not a.grad[torch.from_numpy(dropped)].any()


def test_k2_autograd_function_empty_and_zero_segments():
    x = torch.randn(7, 3, requires_grad=True)
    out = SegmentSumFn.apply(x, torch.zeros(7, dtype=torch.int32), 0)
    assert out.shape == (0, 3)
    out.sum().backward()
    assert torch.equal(x.grad, torch.zeros(7, 3))
    e = torch.zeros(0, 3, requires_grad=True)
    assert torch.equal(SegmentSumFn.apply(e, torch.zeros(0, dtype=torch.int32),
                                          4), torch.zeros(4, 3))
