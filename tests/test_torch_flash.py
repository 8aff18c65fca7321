"""Parity of the port's attention wrapper with the JAX package's, on the
CPU.

The port's ``flash_attention`` runs the kernel's plain version here (the
same online-softmax recurrence over key blocks).  It is held against the
JAX package's ``flash_attention(..., interpret=True)`` (the Pallas kernel
in interpret mode) and its ``attention_ref`` oracle on the same numpy
inputs from a seed, with the tolerance of ``tests/test_kernels.py``
(float32 2e-5, bfloat16 3e-2): the ``(B, H, S, D)`` sweep, causal and
bidirectional, a length that is not a block multiple, and the cases the
wrapper refuses; and the tiling the kernels launch with.  The card-only
tests of the kernels are in ``test_torch_cuda.py``.
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
    flash_bwd_plan,
    flash_cuda,
    flash_plain,
    flash_plan,
)
from repro_torch.kernels.flash.flash import SMEM_LIMIT

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_fits_one_block_at_every_head_dim(dtype):
    """Every D in 1..256 gets a width that covers it and a tiling whose
    dynamic shared memory one Hopper block can have; bfloat16 takes the
    tensor-core kernel at a ``wgmma`` width, float32 the three-pass TF32
    kernel at D % 8 == 0 up to 128 and the FMA kernel otherwise."""
    widths = set()
    for d in range(1, 257):
        plan = flash_plan(d, dtype)
        assert plan.head_dim >= d
        assert 0 < plan.smem_bytes <= SMEM_LIMIT
        widths.add(plan.head_dim)
        if dtype == torch.bfloat16:
            assert plan.kernel == "wgmma"
            # wgmma: 64 rows per warpgroup, k-steps of 16, N a multiple of
            # 8 up to 256; a ring of at least two K/V stages.
            assert plan.block_q % 64 == 0 and plan.stages >= 2
            assert plan.head_dim % 16 == 0 and plan.block_k % 16 == 0
            assert plan.head_dim <= 256 and plan.block_k <= 256
            assert plan.head_dim == min(w for w in (64, 128, 256) if w >= d)
        elif d % 8 == 0 and d <= 128:
            assert plan.kernel == "tf32"
            assert plan.head_dim == min(w for w in (32, 64, 128) if w >= d)
            assert plan.block_q == 128 and plan.stages == 1
            assert plan.block_k == (64 if plan.head_dim == 64 else 32)
        else:
            assert plan.kernel == "fma"
    if dtype == torch.bfloat16:
        assert widths == {64, 128, 256}
        assert [flash_plan(d, dtype).smem_bytes for d in (64, 128, 256)] \
            == [83_008, 99_392, 197_696]
    else:
        assert widths == {16, 32, 64, 128, 256}
        assert flash_plan(256, dtype).smem_bytes == 214_016
        # The TF32 route's hi and lo tiles of Q, K and V^T, and 1 KB.
        assert [flash_plan(d, dtype).smem_bytes for d in (32, 64, 128)] \
            == [50_176, 132_096, 197_632]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_routes_by_type_and_head_dim(dtype):
    """The route of each head dim 1..256, forward and backward: float32
    on the three-pass TF32 kernels where D % 8 == 0 (up to 128 forward,
    64 backward: at 128 the backward's hi and lo tiles would not fit a
    block), bfloat16 on the bf16 tensor-core kernels; the FMA tiles
    elsewhere.  Every plan fits the 232,448 bytes one block may use."""
    routes = {}
    for d in range(1, 257):
        fwd, bwd = flash_plan(d, dtype), flash_bwd_plan(d, dtype)
        routes.setdefault((fwd.kernel, bwd.kernel), []).append(d)
        assert fwd.smem_bytes <= SMEM_LIMIT
        assert bwd.dq_smem <= bwd.dkdv_smem <= SMEM_LIMIT
    eights = list(range(8, 257, 8))
    if dtype == torch.float32:
        assert routes[("tf32", "tf32")] == [d for d in eights if d <= 64]
        assert routes[("tf32", "fma")] == [72, 80, 88, 96, 104, 112, 120,
                                           128]
        assert routes[("fma", "fma")] == [d for d in range(1, 257)
                                          if d % 8 or d > 128]
    else:
        assert routes[("wgmma", "wgmma")] == [d for d in eights if d <= 128]
        assert routes[("wgmma", "fma")] == [d for d in range(1, 257)
                                            if d % 8 or d > 128]
    assert flash_bwd_plan(32, torch.float32)[-2:] == (99_584, 91_136)
    assert flash_bwd_plan(64, torch.float32)[-2:] == (197_888, 181_248)


def test_flash_plan_rejects_what_the_kernels_do_not_take():
    for d in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            flash_plan(d, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_plan(64, torch.float16)
