"""The port on the card: the fused delivery kernel (per class and one
launch per leaf), the bitset intersection kernels (their run cache
too), the Engine's paths through them (``run`` and ``analyze``), and
the segment-sum and attention kernels through their entry points.

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
from repro_torch.core import AnalyticsSpec, Engine, Program
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
    deliver_leaf_cuda,
    fused_deliver,
    leaf_plan,
)
from repro_torch.kernels.flash import (
    attention_ref,
    flash_attention,
    flash_cuda,
    flash_plain,
    flash_plan,
)
from repro_torch.kernels.flash.flash import DTYPES as FLASH_DTYPES
from repro_torch.kernels.flash.flash import _kernel_lib as flash_lib
from repro_torch.kernels.segsum import (
    segment_sum_mxu,
    segsum_cuda,
    segsum_plain,
    segsum_sorted_cuda,
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


def _leaf_layouts(rng, card):
    """A layout with hubs (a class of long rows: spans below the tile),
    30% dead incidences and 300 destinations of degree 0; unpadded and
    with every class padded to twice its rows (dead slots)."""
    n_src, n_dst, nnz = 5000, 3000, 60000
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = rng.integers(0, n_dst - 300, nnz).astype(np.int32)
    dst[:12000] = rng.integers(0, 60, 12000)
    mask = (rng.random(nnz) > 0.3).astype(np.int32)
    lay = build_delivery_layout(src, dst, mask, n_src, n_dst, device=card)
    pad = build_delivery_layout(
        src, dst, mask, n_src, n_dst, device=card,
        class_rows_pad=tuple(2 * r for r in lay.class_rows))
    return n_src, (lay, pad)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "min", "max", "prod", "or"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_cuda_leaf_kernel_equals_plain(card, monoid, dtype):
    rng = np.random.default_rng(6)
    n_src, layouts = _leaf_layouts(rng, card)
    prog = Program(procedure=None, combiner=monoid)
    for lay in layouts:
        plan = leaf_plan(lay)
        assert plan.zero_dst.numel() >= 300
        assert min(plan.spans) < lay.block_n
        for shape in ((n_src,), (n_src, 3)):
            x = (rng.random(shape) > 0.5 if monoid == "or"
                 else _payload(rng, monoid, dtype, shape))
            msgs = torch.as_tensor(x, device=card)
            live = torch.as_tensor(rng.random(n_src) > 0.4, device=card)
            for active in (None, live, live.to(torch.int32)):
                before = deliver_fused_cuda.launches
                got = fused_deliver(msgs, active, lay, prog, lowering="cuda")
                assert deliver_fused_cuda.launches == before + 1
                want = fused_deliver(msgs, active, lay, prog,
                                     lowering="plain")
                assert _same_bits(got.cpu().numpy(), want.cpu().numpy()), (
                    monoid, dtype, shape, lay.class_rows,
                    None if active is None else active.dtype)


@pytest.mark.cuda
def test_cuda_leaf_kernel_is_bitwise_repeatable(card):
    rng = np.random.default_rng(8)
    n_src, layouts = _leaf_layouts(rng, card)
    msgs = torch.as_tensor(rng.standard_normal((n_src, 4)).astype(
        np.float32), device=card)
    for lay in layouts:
        first = deliver_leaf_cuda(msgs, None, lay, "sum")
        again = deliver_leaf_cuda(msgs, None, lay, "sum")
        assert torch.equal(first.view(torch.int32), again.view(torch.int32))
        want = fused_deliver(msgs, None, lay,
                             Program(procedure=None, combiner="sum"),
                             lowering="plain")
        torch.testing.assert_close(first, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_leaf_wrapper_rejects_what_the_kernel_does_not_take(card):
    rng = np.random.default_rng(9)
    n_src, (lay, _) = _leaf_layouts(rng, card)
    msgs = torch.zeros(n_src, 2, device=card)
    with pytest.raises(TypeError, match="float32 or int32"):
        deliver_leaf_cuda(msgs.double(), None, lay, "sum")
    with pytest.raises(ValueError, match="rows"):
        deliver_leaf_cuda(msgs[1:], None, lay, "sum")
    with pytest.raises(ValueError, match="monoids"):
        deliver_leaf_cuda(msgs, None, lay, "or")
    with pytest.raises(ValueError, match="active"):
        deliver_leaf_cuda(msgs, torch.ones(3, dtype=torch.bool, device=card),
                          lay, "sum")


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
@pytest.mark.parametrize("w", [1, 3, 101, 104, 200, "104 unaligned"])
def test_cuda_isect_run_cache_edge_cases(card, w):
    """Id shapes that stress the register run cache, bitwise against the
    plain version: runs across the 32-pair chunks and across a warp's
    turns of the grid-stride loop (P well above one grid's pairs),
    alternating ids, runs of one, P of 1, 31 and 33, triples."""
    rng = np.random.default_rng(11)
    e = 2000
    w_r = 104 if w == "104 unaligned" else w
    flat = _words(rng, (e * w_r + 1,)).to(card)
    bits = (flat[1:] if w == "104 unaligned" else flat[:-1]).view(e, w_r)
    assert (bits.data_ptr() % 16 != 0) == (w == "104 unaligned")

    def runs(lengths, p):
        return np.repeat(rng.integers(0, e, len(lengths)), lengths)[:p]

    p = 600_001
    lengths = rng.choice([1, 2, 31, 32, 33, 64, 255, 256, 257, 3000],
                         p // 16)
    a, b = runs(lengths, p), runs(lengths[::-1], p)
    alt = np.tile(rng.integers(0, e, 2), p)[:p]
    ones = rng.integers(0, e, p)
    cases = [(a, b), (alt, np.roll(alt, 1)), (ones, a), (a[:33], b[:33]),
             (a[:1], b[:1]), (a[:31], alt[:31]), (a, alt, ones), (a, a, a),
             (alt, b, a)]
    for ids in cases:
        t = [torch.as_tensor(x.astype(np.int32), device=card) for x in ids]
        assert torch.equal(isect_fused_cuda(bits, *t),
                           isect_fused_plain(bits, *t)), (w, len(ids[0]))
        if len(t) == 2:
            ga, gb = (bits.index_select(0, x) for x in t)
            assert torch.equal(isect_cuda(ga, gb), isect_plain(ga, gb))


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


def _segsum_tol(e, n, dtype):
    """``tests/test_kernels.py``'s tolerance for a segment sum."""
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    return dict(rtol=tol, atol=tol * 10 * max(1.0, (e / n) ** 0.5 / 3.0))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 64, 100, 256, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_segsum_kernels_equal_plain(card, dtype, d):
    """Both forms against the plain version.  K2a with block_e = 300:
    every tile of 128 rows splits into several work items; a long row
    and heavy tiles (the last one partial) run its combine tree; D = 256
    and 1000 cut the columns into slices; shuffled ids too."""
    rng = np.random.default_rng(d)
    e, n = 50000, 3000
    msgs = torch.as_tensor(rng.standard_normal((e, d)).astype(np.float32),
                           device=card).to(dtype)
    dst = rng.integers(-5, n + 5, e).astype(np.int32)
    dst[:2000] = 17                                    # a long row
    dst[2000:8000] = rng.choice([130, 131, 1500, 2950, 2999], 6000)
    ids = torch.as_tensor(dst, device=card)
    order = torch.sort(ids, stable=True).indices
    ms, ids_s = msgs[order].contiguous(), ids[order].contiguous()
    tol = _segsum_tol(e, n, dtype)
    before = (segsum_cuda.launches, segsum_sorted_cuda.launches)
    got = segment_sum_mxu(msgs, ids, n, block_e=300)
    got_s = segment_sum_mxu(ms, ids_s, n, sorted_dst=True, block_n=50)
    again = segment_sum_mxu(ms, ids_s, n, sorted_dst=True, block_n=50)
    torch.cuda.synchronize()
    assert (segsum_cuda.launches, segsum_sorted_cuda.launches) == (
        before[0] + 1, before[1] + 2)
    assert got.dtype == dtype and got.shape == (n, d)
    want = segsum_plain(msgs, ids, n).float()
    torch.testing.assert_close(got.float(), want, **tol)
    torch.testing.assert_close(got_s.float(), want, **tol)
    assert torch.equal(got_s, again)                   # K2b: same bits
    # Ids outside [0, N) are dropped: the same sums as without them.
    keep = (ids >= 0) & (ids < n)
    torch.testing.assert_close(
        got.float(), segsum_plain(msgs[keep], ids[keep], n).float(), **tol)
    perm = torch.as_tensor(rng.permutation(e), device=card)
    mp, ip = msgs[perm].contiguous(), ids[perm].contiguous()
    torch.testing.assert_close(
        segment_sum_mxu(mp, ip, n, block_e=300).float(),
        segsum_plain(mp, ip, n).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_segsum_more_tiles_than_one_window(card, dtype):
    """K2a with more output tiles (15,625 of 128 rows) than its count
    pass bins at once (8,192): the tiles come in two windows; runs of
    ids, shuffled ids and a heavy tile in the second window.  Integer-
    valued messages: every order of the float32 adds gives the same
    bits, so the result must equal the plain version's bitwise."""
    rng = np.random.default_rng(5)
    e, n, d = 300000, 2000000, 8
    dst = np.sort(rng.integers(-3, n + 3, e)).astype(np.int32)
    dst[:20000] = 1900000
    dst[20000:40000] = rng.permutation(dst[20000:40000])
    msgs = torch.as_tensor(rng.integers(-8, 9, (e, d)).astype(np.float32),
                           device=card).to(dtype)
    ids = torch.as_tensor(dst, device=card)
    assert torch.equal(segment_sum_mxu(msgs, ids, n),
                       segsum_plain(msgs, ids, n))


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_dst", [False, True])
def test_cuda_segsum_edge_cases(card, sorted_dst):
    """E = 0 gives zeros without a launch; ids all outside [0, N) give
    zeros; one segment takes every edge; an infinite message stays in its
    own row."""
    launches = lambda: (segsum_cuda.launches, segsum_sorted_cuda.launches)
    before = launches()
    empty = segment_sum_mxu(torch.zeros(0, 4, device=card),
                            torch.zeros(0, dtype=torch.int32, device=card),
                            9, sorted_dst=sorted_dst)
    assert empty.shape == (9, 4) and not empty.any()
    assert launches() == before
    ones = torch.ones(5000, 2, device=card)
    out = torch.full((5000,), 11, dtype=torch.int32, device=card)
    assert not segment_sum_mxu(ones, out, 11, sorted_dst=sorted_dst).any()
    assert not segment_sum_mxu(ones, -out, 11, sorted_dst=False).any()
    one = segment_sum_mxu(ones, torch.zeros_like(out), 3,
                          sorted_dst=sorted_dst)
    assert torch.equal(one[0], torch.full((2,), 5000.0, device=card))
    assert not one[1:].any()
    msgs = torch.tensor([[1.0], [float("inf")], [2.0], [3.0]], device=card)
    ids = torch.tensor([0, 1, 2, 70], dtype=torch.int32, device=card)
    got = segment_sum_mxu(msgs, ids, 3, sorted_dst=sorted_dst)
    assert got.ravel().tolist() == [1.0, float("inf"), 2.0]


@pytest.mark.cuda
def test_cuda_segsum_wrapper_rejects_what_the_kernel_does_not_take(card):
    msgs = torch.zeros(6, 2, device=card)
    ids = torch.zeros(6, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        segsum_cuda(msgs.double(), ids, 3)
    with pytest.raises(TypeError, match="int32"):
        segsum_cuda(msgs, ids.long(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        segsum_cuda(torch.zeros(2, 6, device=card).t(), ids, 3)
    with pytest.raises(ValueError, match="is on cpu"):
        segsum_cuda(msgs, ids.cpu(), 3)
    with pytest.raises(ValueError, match="num_segments"):
        segsum_sorted_cuda(msgs, ids[:3], 3)


def _flash_qkv(rng, dev, dtype, sq, sk, d, b=2, h=3):
    return tuple(torch.as_tensor(
        rng.standard_normal((b, h, s, d)).astype(np.float32) * scale,
        device=dev).to(dtype) for s, scale in ((sq, 0.3), (sk, 0.3),
                                               (sk, 1.0)))


# Head dims 8, 40, 64, 96, 128 and 256 (every wgmma width, padded and
# not), and 20 (no multiple of 8: the element-wise tile loads).
@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(200, 64), (128, 40), (256, 256), (70, 8),
                                 (333, 96), (257, 128), (90, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_kernel_equals_plain(card, causal, dtype, s, d):
    rng = np.random.default_rng(s + d)
    q, k, v = _flash_qkv(rng, card, dtype, s, s, d)
    before = flash_cuda.launches
    got = flash_attention(q, k, v, causal=causal, block_k=s if not causal
                          else 128)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for want in (flash_plain(q, k, v, causal=causal),
                 attention_ref(q, k, v, causal=causal)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# (Sq, Sk, D, causal): causal Sq < Sk and Sq > Sk with a ragged Sk, one
# query and one key, and Sk no multiple of the 128- or 64-key tile.
@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal", [
    (100, 300, 64, True), (300, 100, 64, True), (300, 129, 128, True),
    (1, 1, 64, True), (1, 1, 128, False), (1, 77, 256, False),
    (5, 200, 256, True), (64, 130, 64, False), (200, 65, 256, False),
    (129, 257, 96, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_ragged_shapes_equal_plain(card, dtype, sq, sk, d,
                                              causal):
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v = _flash_qkv(rng, card, dtype, sq, sk, d, b=1, h=2)
    before = flash_cuda.launches
    got = flash_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for want in (flash_plain(q, k, v, causal=causal),
                 attention_ref(q, k, v, causal=causal)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_unaligned_rows_equal_plain(card, causal):
    """Operands that start 2 bytes past a 16-byte boundary cannot be read
    by TMA; the bfloat16 kernel loads them element by element."""
    rng = np.random.default_rng(5)
    shape = (1, 2, 150, 64)
    n = int(np.prod(shape))
    q, k, v = (torch.as_tensor(rng.standard_normal(n + 1).astype(
        np.float32) * scale, device=card).to(torch.bfloat16)[1:].view(shape)
        for scale in (0.3, 0.3, 1.0))
    assert q.data_ptr() % 16 and q.is_contiguous()
    got = flash_cuda(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), flash_plain(
        q, k, v, causal=causal).float(), rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_flash_bf16_is_bitwise_repeatable(card, d):
    """No atomics: two launches give the same bits."""
    rng = np.random.default_rng(d)
    q, k, v = _flash_qkv(rng, card, torch.bfloat16, 700, 700, d)
    first = flash_cuda(q, k, v, causal=True)
    second = flash_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.cuda
def test_cuda_flash_plan_matches_the_kernel(card):
    """``flash_plan``'s shared memory is what the source launches with."""
    lib = flash_lib()
    for dtype, code in FLASH_DTYPES.items():
        for d in range(1, 257):
            assert lib.flash_smem_bytes(d, code) == flash_plan(
                d, dtype).smem_bytes, (dtype, d)
        assert lib.flash_smem_bytes(257, code) == -1


@pytest.mark.cuda
def test_cuda_flash_wrapper_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros(1, 2, 16, 8, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_cuda(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="float32"):
        flash_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_cuda(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 4, 300, device=card)
        flash_cuda(big, big, big)
    with pytest.raises(ValueError, match="multiple of block_k"):
        flash_attention(q, q[:, :, :10], q[:, :, :10], causal=False)
