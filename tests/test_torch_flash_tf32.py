"""The numbers of K4's float32 kernels on the tensor cores, on the CPU.

The float32 kernels (``csrc/flash.cu``'s ``flash_tf32_kernel``,
``csrc/flash_bwd.cu``'s ``flash_bwd_dkdv_tf32`` / ``flash_bwd_dq_tf32``)
take every product as three TF32 passes: each operand split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and ``lo.hi + hi.lo + hi.hi``
summed in float32.  No card runs here, so ``kernels.flash.ref``'s torch
model of that arithmetic (``tf32_round``, ``tf32_matmul``,
``attention_tf32``) stands in for the kernels: attention, its row
log-sum-exp and its gradients through the model are held against the
JAX package's ``flash`` reference (``repro.kernels.flash.ref
.attention_ref``, and ``jax.grad`` of it) on the same numpy inputs, at
BERT4Rec's head shape bidirectional and at a causal grouped-query shape,
within the float32 limits of the kernels' card checks: the output 2e-5
(rtol = atol), each gradient 1e-4 of its largest magnitude, ``lse`` 1e-5.
One TF32 pass, the same model with ``passes=1``, reads above the
output and gradient limits: the checks can fail.  The kernels themselves
are held to the same limits on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ref import attention_ref as j_ref
from repro_torch.kernels.flash import flash_plain
from repro_torch.kernels.flash.ref import (
    attention_tf32,
    tf32_matmul,
    tf32_round,
)

OUT_TOL = 2e-5    # rtol = atol, the forward's float32 limit
LSE_TOL = 1e-5    # rtol = atol
GRAD_TOL = 1e-4   # of each gradient's largest magnitude

# (B, H, KvH, S, D, causal): BERT4Rec's attention (2 heads of 32,
# 200 items, bidirectional) and a causal grouped-query case at head dim 64.
CASES = [(4, 2, 2, 200, 32, False), (1, 4, 2, 512, 64, True)]


def _inputs(b, h, kvh, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    dout = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, dout


def _jax_reference(q, k, v, dout, causal):
    """The JAX package's output, lse and gradients, K and V repeated to
    the query heads in its grouped-query order (query head h reads KV
    head h // (H // KvH)) and their gradients summed back."""
    rep = q.shape[1] // k.shape[1]

    def attend(q, k, v):
        return j_ref(q, jnp.repeat(k, rep, axis=1),
                     jnp.repeat(v, rep, axis=1), causal=causal)

    out, vjp = jax.vjp(attend, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, jnp.repeat(k, rep, axis=1)) / (
        jnp.sqrt(jnp.float32(q.shape[-1])))
    if causal:
        mask = jnp.tril(jnp.ones((q.shape[2], k.shape[2]), bool))
        s = jnp.where(mask[None, None], s, -1e30)
    lse = jax.nn.logsumexp(s, axis=-1)
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _model(q, k, v, dout, causal, passes):
    out, lse, grads = attention_tf32(
        *(torch.as_tensor(x) for x in (q, k, v, dout)), causal=causal,
        passes=passes)
    return out.numpy(), lse.numpy(), [g.numpy() for g in grads]


def _shares(got, want):
    """Each check's error over its limit: output, lse, dQ, dK, dV."""
    out, lse, grads = got
    w_out, w_lse, w_grads = want
    shares = [np.max(np.abs(out - w_out)
                     / (OUT_TOL + OUT_TOL * np.abs(w_out))),
              np.max(np.abs(lse - w_lse)
                     / (LSE_TOL + LSE_TOL * np.abs(w_lse)))]
    shares += [np.max(np.abs(g - w)) / np.max(np.abs(w)) / GRAD_TOL
               for g, w in zip(grads, w_grads)]
    return shares


@pytest.mark.parametrize("b,h,kvh,s,d,causal", CASES)
def test_three_pass_tf32_attention_is_within_the_float32_limits(
        b, h, kvh, s, d, causal):
    q, k, v, dout = _inputs(b, h, kvh, s, d, seed=s + d)
    want = _jax_reference(q, k, v, dout, causal)
    got = _model(q, k, v, dout, causal, passes=3)
    shares = _shares(got, want)
    assert max(shares) <= 1.0, dict(zip(
        ("out", "lse", "dq", "dk", "dv"), shares))
    # The model's forward is the port's plain version's, too.
    plain = flash_plain(*(torch.as_tensor(x) for x in (q, k, v)),
                        causal=causal, return_lse=True)
    np.testing.assert_allclose(got[0], plain[0].numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(got[1], plain[1].numpy(), rtol=LSE_TOL,
                               atol=LSE_TOL)


@pytest.mark.parametrize("b,h,kvh,s,d,causal", CASES)
def test_one_tf32_pass_reads_above_the_float32_limits(b, h, kvh, s, d,
                                                      causal):
    """Plain TF32 (one pass, ``hi.hi``) breaks the output and gradient
    limits the three passes keep (the lse of these small scores may stay
    within its own)."""
    q, k, v, dout = _inputs(b, h, kvh, s, d, seed=s + d)
    want = _jax_reference(q, k, v, dout, causal)
    shares = _shares(_model(q, k, v, dout, causal, passes=1), want)
    assert shares[0] > 1.0 and min(shares[2:]) > 1.0, shares


def test_tf32_round_is_round_to_nearest_ties_away_at_ten_bits():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + ulp + ulp / 2,
                      -(one + ulp / 2), one + ulp / 4, 3.0e-40, 0.0, -0.0])
    got = tf32_round(x)
    assert got.tolist()[:5] == [one, one + ulp, one + 2 * ulp, -(one + ulp),
                                one]
    # A subnormal is rounded on the same grid: 2^-136 apart.
    assert got[5].item() != 0.0
    assert abs(got[5].item() - 3.0e-40) <= 2.0 ** -137
    assert got[6].item() == 0.0 and got[7].view(torch.int32).item() == \
        torch.tensor(-0.0).view(torch.int32).item()
    # Every rounded value has its 13 low bits clear.
    bits = tf32_round(torch.randn(1000)).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


def test_three_pass_product_is_near_float64_where_one_pass_is_not():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 200)).astype(np.float32)
    b = rng.standard_normal((200, 32)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    three = tf32_matmul(ta, tb).numpy()
    one = tf32_matmul(ta, tb, passes=1).numpy()
    ieee = (ta @ tb).numpy()
    err3 = np.abs(three - exact).max() / scale
    err1 = np.abs(one - exact).max() / scale
    err32 = np.abs(ieee - exact).max() / scale
    assert err3 < 4 * err32 + 1e-7 and err1 > 100 * err3
    with pytest.raises(ValueError, match="passes"):
        tf32_matmul(ta, tb, passes=2)
