"""The port on the card: the fused delivery kernel, the bitset
intersection kernels, and the Engine's paths through them (``run`` and
``analyze``).

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
from repro_torch.core import AnalyticsSpec, Engine
from repro_torch.data import powerlaw_hypergraph
from repro_torch.kernels import _nvcc
from repro_torch.kernels.isect import (
    isect_cuda,
    isect_fused_cuda,
    isect_fused_plain,
    isect_plain,
    pair_intersect_bitset,
)
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


def _words(rng, shape):
    """Random int32 words, a third of them with bit 31 set and some all
    ones."""
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    x[rng.random(shape) < 0.05] = -1
    return torch.as_tensor(x.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 3, 7, 101, 104, 256])
def test_cuda_isect_kernels_equal_plain(card, w):
    rng = np.random.default_rng(w)
    e, p = 3000, 20000
    bits = _words(rng, (e, w)).to(card)
    ids = [torch.as_tensor(rng.integers(0, e, p).astype(np.int32),
                           device=card) for _ in range(3)]
    ids[0][:500] = 7                                   # a hot row
    ids[1][:100] = ids[0][:100]                        # self pairs
    before = (isect_cuda.launches, isect_fused_cuda.launches)
    for ec in (None, ids[2]):
        got = isect_fused_cuda(bits, ids[0], ids[1], ec)
        want = isect_fused_plain(bits, ids[0], ids[1], ec)
        assert torch.equal(got, want), (w, ec is not None)
    a = bits.index_select(0, ids[0])
    b = bits.index_select(0, ids[1])
    assert torch.equal(isect_cuda(a, b), isect_plain(a, b))
    assert torch.equal(isect_cuda(bits, bits),
                       isect_fused_plain(bits, *(torch.arange(
                           e, dtype=torch.int32, device=card),) * 2))
    assert torch.equal(pair_intersect_bitset(bits, ids[0], ids[1],
                                             fused=False),
                       isect_fused_plain(bits, ids[0], ids[1]))
    torch.cuda.synchronize()
    assert (isect_cuda.launches, isect_fused_cuda.launches) == (
        before[0] + 3, before[1] + 2)
    # an empty batch launches nothing
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    assert isect_fused_cuda(bits, empty, empty).shape == (0,)
    assert isect_fused_cuda.launches == before[1] + 2


@pytest.mark.cuda
def test_cuda_isect_wrapper_rejects_what_the_kernel_does_not_take(card):
    bits = torch.zeros((10, 8), dtype=torch.int32, device=card)
    ids = torch.zeros(4, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32"):
        isect_fused_cuda(bits.long(), ids, ids)
    with pytest.raises(TypeError, match="int32"):
        isect_fused_cuda(bits, ids.long(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        isect_cuda(bits.t().contiguous().t(), bits)
    with pytest.raises(ValueError, match="is on cpu"):
        isect_fused_cuda(bits, ids.cpu(), ids)
    with pytest.raises(ValueError, match="ids"):
        isect_fused_cuda(bits, ids, ids[:3])


@pytest.mark.cuda
def test_cuda_engine_analyze_kernel_matches_merge_and_cpu(card):
    hg_cpu = powerlaw_hypergraph(3316, 1000, mean_cardinality=4, seed=2,
                                 device="cpu")
    hg_gpu = powerlaw_hypergraph(3316, 1000, mean_cardinality=4, seed=2,
                                 device=card)
    for spec_kw in (dict(mode="sample", n_samples=300),
                    dict(mode="exact"),
                    dict(task="pair_intersections")):
        want = Engine(device="cpu").analyze(AnalyticsSpec(hg_cpu, **spec_kw))
        before = isect_fused_cuda.launches
        got = Engine(device=card, intersect_kernel="bitset",
                     representation="bipartite").analyze(
            AnalyticsSpec(hg_gpu, **spec_kw))
        merge = Engine(device=card, intersect_kernel="merge").analyze(
            AnalyticsSpec(hg_gpu, **spec_kw))
        assert got.kernel == "bitset" and merge.kernel == "merge"
        assert isect_fused_cuda.launches > before
        for res in (got, merge):
            if spec_kw.get("task") == "pair_intersections":
                for x, y in zip(res.value, want.value):
                    assert np.array_equal(x, y)
                continue
            for f in ("counts", "n_triples") if res.mode == "exact" else (
                    "counts", "ci_low", "ci_high", "n_triples_seen"):
                assert np.array_equal(getattr(res.value, f),
                                      getattr(want.value, f)), f
