"""Parity of the port's attention wrapper with the JAX package's, on the
CPU.

The port's ``flash_attention`` runs the kernel's plain version here (the
same online-softmax recurrence over key blocks).  It is held against the
JAX package's ``flash_attention(..., interpret=True)`` (the Pallas kernel
in interpret mode) and its ``attention_ref`` oracle on the same numpy
inputs from a seed, with the tolerance of ``tests/test_kernels.py``
(float32 2e-5, bfloat16 3e-2): the ``(B, H, S, D)`` sweep, causal and
bidirectional, a length that is not a block multiple, and the cases the
wrapper refuses.  The card-only tests of the kernel are in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ops import flash_attention as j_flash
from repro.kernels.flash.ref import attention_ref as j_ref
from repro_torch.kernels.flash import (
    attention_ref,
    flash_attention,
    flash_cuda,
    flash_plain,
)

SWEEP = [(2, 3, 256, 64), (1, 2, 128, 32), (2, 2, 384, 64), (1, 1, 128, 128)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(b, h, sq, d, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = sq if sk is None else sk
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32) * 0.3,
            rng.standard_normal((b, h, sk, d)).astype(np.float32) * 0.3,
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _port(fn, qkv, dtype, **kw):
    t = [torch.as_tensor(x).to(DTYPES[dtype][0]) for x in qkv]
    got = fn(*t, **kw)
    assert got.dtype == DTYPES[dtype][0] and got.shape == t[0].shape
    return got.float().numpy()


def _jax(fn, qkv, dtype, **kw):
    return np.asarray(fn(*(jnp.asarray(x, DTYPES[dtype][1]) for x in qkv),
                         **kw), np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,h,s,d", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_sweep_matches_jax(b, h, s, d, dtype, causal):
    qkv = _qkv(b, h, s, d, b * h + s)
    got = _port(flash_attention, qkv, dtype, causal=causal)
    _close(got, _jax(j_ref, qkv, dtype, causal=causal), dtype)
    _close(got, _port(attention_ref, qkv, dtype, causal=causal), dtype)
    if causal or s == 128:
        # The Pallas kernel in interpret mode is slow on the CPU: every
        # causal case and the one-tile bidirectional ones.
        _close(got, _jax(j_flash, qkv, dtype, causal=causal,
                         interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_padded_sequence_matches_jax(dtype):
    """S = 200 is no multiple of the 128 blocks: the JAX package pads to
    256, the port masks; both give the oracle."""
    qkv = _qkv(1, 2, 200, 32, 9)
    got = _port(flash_attention, qkv, dtype, causal=True)
    _close(got, _jax(j_flash, qkv, dtype, causal=True, interpret=True),
           dtype)
    _close(got, _jax(j_ref, qkv, dtype, causal=True), dtype)


@pytest.mark.parametrize("block_q,block_k", [(48, 80), (200, 16), (7, 300)])
def test_flash_plain_blocks_do_not_change_the_answer(block_q, block_k):
    qkv = _qkv(1, 2, 200, 16, 4)
    for causal in (True, False):
        want = _port(attention_ref, qkv, "float32", causal=causal)
        _close(_port(flash_plain, qkv, "float32", causal=causal,
                     block_q=block_q, block_k=block_k), want, "float32")


def test_flash_bidirectional_padded_keys_raise():
    qkv = _qkv(1, 1, 200, 16, 2)
    with pytest.raises(ValueError, match="multiple of block_k"):
        _port(flash_attention, qkv, "float32", causal=False)
    with pytest.raises(AssertionError):
        _jax(j_flash, qkv, "float32", causal=False, interpret=True)
    # A key count that is a block multiple goes through.
    got = _port(flash_attention, qkv, "float32", causal=False, block_k=40)
    _close(got, _jax(j_ref, qkv, "float32", causal=False), "float32")


def test_flash_causal_more_queries_than_keys_follows_the_oracle():
    """Causal Sq > Sk with a ragged Sk: the port keeps to
    ``attention_ref``; the JAX kernel lets its zero padding keys into the
    softmax of the queries past Sk (a reference-side quirk)."""
    qkv = _qkv(1, 1, 200, 16, 0, sk=100)
    got = _port(flash_attention, qkv, "float32", causal=True)
    _close(got, _jax(j_ref, qkv, "float32", causal=True), "float32")
    tpu = _jax(j_flash, qkv, "float32", causal=True, interpret=True)
    _close(got[:, :, :100], tpu[:, :, :100], "float32")
    assert np.abs(got[:, :, 100:] - tpu[:, :, 100:]).max() > 1e-3


def test_flash_rejects_what_it_does_not_take():
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="positive"):
        flash_attention(q, q, q, block_q=0)


def test_flash_cpu_takes_the_plain_version():
    before = flash_cuda.launches
    qkv = _qkv(1, 2, 96, 8, 1)
    t = [torch.as_tensor(x) for x in qkv]
    assert torch.equal(flash_cuda(*t), flash_plain(*t))
    flash_attention(*t, causal=False, block_k=32)
    assert flash_cuda.launches == before
