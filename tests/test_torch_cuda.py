"""The port on the card: the fused delivery kernel and the Engine's main
path through it.

Every test here is marked ``cuda`` and skips without a CUDA card and
``nvcc``.  The file imports nothing of JAX, so it runs where the card is:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import (
    connected_components_spec,
    pagerank_spec,
    shortest_paths_spec,
)
from repro_torch.core import Engine
from repro_torch.data import powerlaw_hypergraph
from repro_torch.kernels import _nvcc
from repro_torch.kernels.deliver import (
    build_delivery_layout,
    deliver_fused_cuda,
    deliver_fused_plain,
)
from repro_torch.sparse.segment import MONOIDS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if _nvcc.find_nvcc() is None:
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda")


def _payload(rng, monoid, dtype, shape):
    """Exact payloads: every fold order gives the same bits."""
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
    if monoid == "prod":
        return rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape)
    x = rng.integers(-4, 5, shape).astype(np.float32)
    if monoid in ("min", "max"):
        x[rng.random(shape) < 0.05] = np.nan
    return x


def _same_bits(got, want):
    return got.shape == want.shape and got.dtype == want.dtype and \
        np.array_equal(got, want, equal_nan=got.dtype.kind == "f")


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "min", "max", "prod"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_cuda_kernel_equals_plain(card, monoid, dtype):
    rng = np.random.default_rng(3)
    n_src, n_dst, nnz = 5000, 3000, 40000
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = np.where(rng.random(nnz) < 0.05, 17,
                   rng.integers(0, n_dst, nnz)).astype(np.int32)
    lay = build_delivery_layout(src, dst, None, n_src, n_dst, device=card)
    x = _payload(rng, monoid, dtype, (n_src + 1, 3))
    msgs_aug = torch.as_tensor(x, device=card)
    msgs_aug[-1] = MONOIDS[monoid].identity(msgs_aug.dtype)
    act = torch.as_tensor((rng.random(n_src + 1) > 0.3).astype(np.int32),
                          device=card)
    before = deliver_fused_cuda.launches
    for act_aug in (None, act):
        for c in range(lay.n_classes):
            args = (msgs_aug, act_aug, lay.class_src[c], lay.class_dst[c],
                    lay.class_bounds[c], lay.class_rows[c], monoid)
            kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[c])
            got = deliver_fused_cuda(*args, **kw).cpu().numpy()
            want = deliver_fused_plain(*args, **kw).cpu().numpy()
            assert _same_bits(got, want), (monoid, dtype, c)
    assert deliver_fused_cuda.launches == before + 2 * lay.n_classes


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(card):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 30, 400).astype(np.int32)
    dst = rng.integers(0, 20, 400).astype(np.int32)
    lay = build_delivery_layout(src, dst, None, 30, 20, device=card)
    msgs_aug = torch.zeros(31, 4, device=card)
    args = (lay.class_src[0], lay.class_dst[0], lay.class_bounds[0],
            lay.class_rows[0])
    kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[0])
    with pytest.raises(TypeError, match="float32 or int32"):
        deliver_fused_cuda(msgs_aug.double(), None, *args, "sum", **kw)
    with pytest.raises(ValueError, match="contiguous"):
        deliver_fused_cuda(msgs_aug.t().contiguous().t(), None, *args,
                           "sum", **kw)
    with pytest.raises(ValueError, match="monoids"):
        deliver_fused_cuda(msgs_aug, None, *args, "or", **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        deliver_fused_cuda(msgs_aug, None, lay.class_src[0].cpu(),
                           *args[1:], "sum", **kw)


@pytest.mark.cuda
def test_cuda_engine_fused_matches_cpu_reference(card):
    hg_cpu = powerlaw_hypergraph(3000, 2000, mean_cardinality=6, seed=5,
                                 device="cpu")
    hg_gpu = powerlaw_hypergraph(3000, 2000, mean_cardinality=6, seed=5,
                                 device=card)
    cpu = Engine(device="cpu", collect_stats=True)
    gpu = Engine(device=card, collect_stats=True)
    for make, exact in ((lambda h: shortest_paths_spec(h, 0), True),
                        (connected_components_spec, True),
                        (lambda h: pagerank_spec(h, iters=10), False)):
        want = cpu.run(make(hg_cpu), delivery="xla")
        before = deliver_fused_cuda.launches
        got = gpu.run(make(hg_gpu), delivery="pallas_fused")
        assert deliver_fused_cuda.launches > before
        for a, b in zip(got.value, want.value):
            a = a.cpu().numpy()
            b = b.numpy()
            if exact:
                assert _same_bits(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        for a, b in zip(got.superstep_stats, want.superstep_stats):
            assert torch.equal(a.cpu(), b)
