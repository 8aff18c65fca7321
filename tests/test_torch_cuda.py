"""The port on the card: the fused delivery kernel (per class and one
launch per leaf, wide messages too), the bitset intersection kernels
(their run cache too), the Engine's paths through them (``run``,
``analyze``, and ``compile``'s CUDA-graph replay of one superstep pair,
``run`` and ``run_batch``), and the segment-sum and attention kernels
through their entry points.

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
    random_walk_spec,
    shortest_paths_spec,
)
from repro_torch.core import AnalyticsSpec, Engine, Program, tree_leaves
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
    deliver_leaf_plain,
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
from repro_torch.kernels.segsum import segsum as segsum_module
from repro_torch.kernels.segsum import (
    segment_sum_mxu,
    segsum_cuda,
    segsum_plain,
    segsum_sorted_cuda,
    segsum_sorted_plain,
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


# Row lengths of K2b's skewed cases: every edge into one row; Apache's
# vertex side in shape (one row of 6,465 edges beside rows of about 130);
# short rows, a tenth of them empty.
K2B_SKEW = {
    "one segment": lambda rng: np.array([300_000, 0, 0]),
    "a 6,465-edge row beside short ones": lambda rng: np.concatenate(
        [rng.integers(1, 260, 1600), [6465], rng.integers(1, 260, 1700)]),
    "short rows, some empty": lambda rng: rng.integers(0, 8, 40_000),
}


def _k2b_case(card, case, d, dtype, rng):
    """(offsets, E, integer-valued msgs, random msgs) of a skewed case,
    with edges before row 0 and after the last row (dropped)."""
    lengths = K2B_SKEW[case](rng)
    off = 5 + np.concatenate([[0], np.cumsum(lengths)])
    e = int(off[-1]) + 9
    ints = torch.as_tensor(rng.integers(-8, 9, (e, d)).astype(np.float32),
                           device=card).to(dtype)
    floats = torch.as_tensor(rng.standard_normal((e, d)).astype(np.float32),
                             device=card).to(dtype)
    return torch.as_tensor(off.astype(np.int32), device=card), e, ints, floats


def _k2b_exact(msgs, offsets, n):
    """The sums in float64, rounded once to the type of msgs."""
    off = offsets.long().cpu()
    ids = torch.repeat_interleave(torch.arange(n), off.diff())
    out = torch.zeros(n, msgs.shape[1], dtype=torch.float64)
    out.index_add_(0, ids, msgs[int(off[0]):int(off[-1])].cpu().double())
    return out.to(msgs.dtype).float()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2B_SKEW))
@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_segsum_sorted_skewed_rows(card, case, d, dtype):
    """K2b on skewed rows, narrow and wide, aligned and not: bitwise the
    plain version on integer-valued messages, within tolerance of the
    float64 sums on random ones, the same bits over two runs, one launch
    a call.  The unaligned base (one element past a 16-byte boundary)
    takes the element-wise loads."""
    rng = np.random.default_rng(d + len(case))
    offsets, e, ints, floats = _k2b_case(card, case, d, dtype, rng)
    n = offsets.numel() - 1
    before = segsum_sorted_cuda.launches
    assert torch.equal(segsum_sorted_cuda(ints, offsets, n),
                       segsum_sorted_plain(ints, offsets, n))
    flat = torch.empty(e * d + 1, dtype=dtype, device=card)
    unaligned = flat[1:].view(e, d)
    unaligned.copy_(floats)
    tol = _segsum_tol(e, n, dtype)
    for m in (floats, unaligned):
        got = segsum_sorted_cuda(m, offsets, n)
        assert torch.equal(got, segsum_sorted_cuda(m, offsets, n))
        torch.testing.assert_close(got.float(), _k2b_exact(m, offsets, n)
                                   .to(card), **tol)
    torch.cuda.synchronize()
    assert segsum_sorted_cuda.launches == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("block_e", [1, 64, 256, 2048])
@pytest.mark.parametrize("d", [1, 64])
def test_cuda_segsum_sorted_block_e(card, block_e, d):
    """K2b through ``segment_sum_mxu(sorted_dst=True)`` at other block
    sizes (block_e = 1: a block per item or two, so the long row's pieces
    climb four or five levels of the combine tree): bitwise the plain
    version on integer-valued messages, repeatable, tickets zeroed
    again."""
    rng = np.random.default_rng(block_e)
    lengths = np.concatenate([rng.integers(0, 9, 3000), [70_000],
                              rng.integers(0, 9, 3000)])
    ids = torch.as_tensor(np.repeat(np.arange(lengths.size), lengths)
                          .astype(np.int32), device=card)
    msgs = torch.as_tensor(rng.integers(-8, 9, (ids.numel(), d)).astype(
        np.float32), device=card)
    got = segment_sum_mxu(msgs, ids, lengths.size, sorted_dst=True,
                          block_e=block_e)
    assert torch.equal(got, segsum_plain(msgs, ids, lengths.size))
    assert torch.equal(got, segment_sum_mxu(msgs, ids, lengths.size,
                                            sorted_dst=True, block_e=block_e))
    # The kernel leaves its ticket buffer as it found it: zeroed.
    assert not any(t.any() for t in segsum_module._K2B_TICKETS.values())


@pytest.mark.cuda
def test_cuda_segsum_sorted_failed_launch_drops_its_tickets(card,
                                                            monkeypatch):
    """A K2b launch that returns an error raises and drops its stream's
    ticket buffer, so the next call starts from a new zeroed one."""
    msgs = torch.ones(6, 2, device=card)
    off = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=card)
    assert torch.equal(segsum_sorted_cuda(msgs, off, 3),
                       torch.full((3, 2), 2.0, device=card))
    key = (msgs.device.index, torch.cuda.current_stream(card).cuda_stream)
    assert key in segsum_module._K2B_TICKETS

    class Failing:
        @staticmethod
        def segsum_sorted_launch(*args):
            return 1

    monkeypatch.setattr(segsum_module, "_kernel_lib", lambda: Failing)
    with pytest.raises(RuntimeError, match="error 1"):
        segsum_sorted_cuda(msgs, off, 3)
    assert key not in segsum_module._K2B_TICKETS
    monkeypatch.undo()
    assert torch.equal(segsum_sorted_cuda(msgs, off, 3),
                       torch.full((3, 2), 2.0, device=card))


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
    with pytest.raises(ValueError, match="block_e"):
        segsum_sorted_cuda(msgs, ids[:4], 3, block_e=0)


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


def _card_hg(card, seed=5):
    return powerlaw_hypergraph(3000, 2000, mean_cardinality=6, seed=seed,
                               device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 64])
def test_cuda_leaf_kernel_wide_messages_on_a_padded_layout(card, d):
    """K1 at the batched path's widths (B·d values a row) on a
    bucket-padded layout, bitwise against its plain version."""
    hg = _card_hg(card)
    hgp = hg.padded(4096, 2048, 32768)
    lay = build_delivery_layout(hgp.src, hgp.dst, hgp.e_mask,
                                hgp.n_vertices, hgp.n_hyperedges)
    rng = np.random.default_rng(d)
    for monoid in ("min", "max", "sum"):
        msgs = torch.as_tensor(rng.integers(-50, 50, (lay.n_src, d)),
                               dtype=torch.float32, device=card)
        active = torch.as_tensor(rng.random(lay.n_src) < 0.6, device=card)
        for act in (None, active):
            got = deliver_leaf_cuda(msgs, act, lay, monoid)
            want = deliver_leaf_plain(msgs, act, lay, monoid)
            torch.cuda.synchronize()
            assert _same_bits(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_compiled_run_replays_a_graph_and_matches_engine_run(card):
    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused", collect_stats=True)
    for make, exact, leaves in (
            (lambda h: shortest_paths_spec(h, 0), True, 2),
            (connected_components_spec, True, 2),
            (lambda h: pagerank_spec(h, iters=10), False, 3)):
        spec = make(hg)
        compiled = eng.compile(spec)
        compiled.run()
        traces = eng.cache_stats()["traces"]
        before = deliver_fused_cuda.launches
        got = compiled.run()
        torch.cuda.synchronize()
        m = got.decision["measured"]
        assert m["graph"] and eng.cache_stats()["traces"] == traces
        assert deliver_fused_cuda.launches - before == m["pairs_run"] * leaves
        want = eng.run(spec)
        for a, b in zip(got.value, want.value):
            if exact:
                assert _same_bits(a.cpu().numpy(), b.cpu().numpy())
            else:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        for a, b in zip(got.superstep_stats, want.superstep_stats):
            assert torch.equal(a, b)
        assert "degraded_from" not in got.decision


@pytest.mark.cuda
@pytest.mark.parametrize("n_queries", [5, 8])
def test_cuda_run_batch_matches_sequential_runs(card, n_queries):
    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused", collect_stats=True)
    compiled = eng.compile(shortest_paths_spec(hg, 0))
    sources = np.arange(0, 300 * n_queries, 300, dtype=np.int32)
    res = compiled.run_batch(sources)
    assert res.decision["measured"]["graph"]
    slowest = 0
    for i, s in enumerate(sources):
        one = compiled.run(query=int(s))
        for a, b in zip(one.value, res.value):
            assert _same_bits(a.cpu().numpy(), b[i].cpu().numpy())
        for a, b in zip(one.superstep_stats, res.superstep_stats):
            assert torch.equal(a, b[i])
        slowest = max(slowest, one.decision["measured"]["pairs_run"])
    assert res.supersteps_executed == slowest
    walk = eng.compile(random_walk_spec(hg, iters=12))
    seeds = sources[:3]
    batch = walk.run_batch(seeds).value
    for i, s in enumerate(seeds):
        torch.testing.assert_close(batch[i], walk.run(query=int(s)).value,
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_cuda_compiled_k1_launch_failure_raises(card, monkeypatch):
    """A K1 launch failure on the card surfaces from ``run`` and
    ``run_batch``: no twin serves the request with plain delivery, and
    the failed build leaves no cache entry behind."""
    from repro_torch.kernels.deliver import fused as fused_module

    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused")
    compiled = eng.compile(shortest_paths_spec(hg, 0, 8))

    class Failing:
        @staticmethod
        def deliver_fused_launch(*args):
            return 1

    monkeypatch.setattr(fused_module, "_kernel_lib", lambda: Failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        compiled.run()
    with pytest.raises(RuntimeError, match="launch failed"):
        compiled.run_batch(np.arange(4, dtype=np.int32))
    stats = eng.cache_stats()
    assert stats["entries"] == 0 and stats["traces"] == 0
    monkeypatch.undo()
    res = compiled.run()
    assert res.decision["measured"]["graph"]
    assert "degraded_from" not in res.decision
    (exe,) = eng._exec_cache.values()
    assert 0 <= exe.pool_bytes < exe.nbytes == eng.cache_stats()["bytes"]


@pytest.mark.cuda
def test_cuda_capture_fails_loudly_on_a_host_read_of_the_step(card):
    """A procedure that reads the step on the host runs eagerly
    (``Engine.run``) but cannot be captured: ``compile`` raises rather
    than falling back to eager pairs."""
    hg = _card_hg(card)
    spec = shortest_paths_spec(hg, 0, 8)
    inner = spec.v_program.procedure

    def host_step(step, ids, attr, msg, deg):
        if int(step) < 0:  # a host read, never true
            raise AssertionError
        return inner(step, ids, attr, msg, deg)

    spec = spec._replace(v_program=Program(procedure=host_step,
                                           combiner="min"))
    eng = Engine(device=card, delivery="pallas_fused")
    assert torch.isfinite(eng.run(spec).value[0]).any()
    with pytest.raises(RuntimeError):
        eng.compile(spec).run()
    assert eng.cache_stats()["traces"] == 0
    # the card is still usable after the failed capture
    assert eng.compile(shortest_paths_spec(hg, 0, 8)).run().decision[
        "measured"]["graph"]


# -- the clique representation, the card's delivery term, tracing ----------

def _clique_graph(card, scale=0.01):
    from repro_torch.core import to_graph
    from repro_torch.data import make_dataset

    return to_graph(make_dataset("dblp", scale, seed=0, device=card))


def _graph_pagerank_plain(g, iters, alpha=0.15):
    """Both sums by ``index_add_`` over the edges in their own order."""
    nv = g.n_vertices
    w = g.e_attr.float()
    out_w = segsum_plain(w[:, None], g.src, nv)[:, 0].clamp(min=1e-12)
    rank = torch.ones(nv, dtype=torch.float32, device=w.device)
    for _ in range(iters):
        contrib = (rank / out_w)[g.src] * w
        rank = alpha + (1.0 - alpha) * segsum_plain(
            contrib[:, None], g.dst, nv)[:, 0]
    return rank


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 30])
def test_cuda_graph_pagerank_equals_plain(card, iters):
    from repro_torch.algorithms import graph_pagerank

    g = _clique_graph(card)
    assert g.src.device.type == "cuda"
    segsum_sorted_cuda.launches = 0
    got = graph_pagerank(g, iters=iters)
    torch.cuda.synchronize()
    assert segsum_sorted_cuda.launches == iters  # K2b once an iteration
    want = _graph_pagerank_plain(g, iters)
    rel = ((got - want).abs() / want.abs()).max().item()
    assert rel <= 1e-5


@pytest.mark.cuda
def test_cuda_k2b_repeats_bitwise_over_30_calls_with_one_set_of_offsets(
        card):
    from repro_torch.kernels.segsum import csr_row_offsets

    g = _clique_graph(card)
    nv = g.n_vertices
    order = torch.sort(g.dst, stable=True).indices
    off = csr_row_offsets(g.dst[order], nv)
    gen = torch.Generator(device=card).manual_seed(0)
    msgs = torch.rand(g.dst.numel(), 1, generator=gen, device=card)
    first = segsum_sorted_cuda(msgs, off, nv)
    for _ in range(29):
        again = segsum_sorted_cuda(msgs, off, nv)
        assert torch.equal(again.view(torch.int32), first.view(torch.int32))
    want = segsum_sorted_plain(msgs, off, nv)
    assert torch.allclose(first, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_clique_run_and_vertex_pagerank_auto(card):
    from repro_torch.algorithms import vertex_pagerank_spec
    from repro_torch.core import HyperGraph, to_graph

    fig1 = HyperGraph.from_hyperedge_lists(
        [[0, 1], [0, 1, 2, 3], [0, 3, 4], [2, 3]], n_vertices=5,
        device=card)
    res = Engine(device=card).run(vertex_pagerank_spec(fig1, iters=8))
    assert res.representation == "clique"
    want = _graph_pagerank_plain(to_graph(fig1), 8)
    assert torch.allclose(res.value, want, rtol=1e-5, atol=0)
    m = res.decision["measured"]
    assert m["wall_s"] >= m["device_wait_s"] >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d,nnz_scale,pick", [
    (1, 0.002, "pallas_fused"), (16, 0.002, "pallas_fused"),
    (64, 0.002, "pallas_fused"), (64, 0.05, "pallas_fused"),
    (1, 0.001, "xla"), (64, 0.001, "xla")])
def test_cuda_select_delivery_names_the_measured_term(card, d, nnz_scale,
                                                      pick):
    from repro_torch.algorithms import AlgorithmSpec
    from repro_torch.core.executor import H100_FUSED_MIN_NNZ, select_delivery
    from repro_torch.data import make_dataset

    hg = make_dataset("dblp", nnz_scale, seed=0, device=card)
    prog = Program(procedure=None, combiner="sum")
    spec = AlgorithmSpec(hg0=hg, initial_msg=torch.zeros(d), v_program=prog,
                         he_program=prog, max_iters=1, extract=lambda o: o)
    got, why = select_delivery(spec, hg)
    assert got == pick
    assert why["lowering"] == "cuda"
    assert why["min_nnz"] == H100_FUSED_MIN_NNZ
    assert (hg.nnz >= H100_FUSED_MIN_NNZ) == (pick == "pallas_fused")
    assert ("measured faster" if pick == "pallas_fused"
            else "smallest measured") in why["reason"]
    assert "waits for H100" not in why["reason"]


@pytest.mark.cuda
def test_cuda_traced_run_records_device_wait(card):
    from repro_torch.algorithms import vertex_pagerank_spec
    from repro_torch.obs import Tracer

    tr = Tracer()
    eng = Engine(device=card, tracer=tr, delivery="pallas_fused")
    hg = powerlaw_hypergraph(3000, 1500, mean_cardinality=6, seed=1,
                             device=card)
    spec = pagerank_spec(hg, iters=5)
    ex = eng.explain(spec)
    res = eng.run(spec)
    assert ex["axes"]["delivery"]["inputs"]["lowering"] == "cuda"
    assert ex["config"] == res.config
    eng.run(vertex_pagerank_spec(hg, iters=5), representation="clique")
    runs = [s for s in tr.spans() if s.name == "engine.run"]
    assert len(runs) == 2
    for sp in runs:
        assert sp.args["device_wait_s"] >= 0.0
        assert sp.dur_s >= sp.args["device_wait_s"]
    assert "engine.layout_build" in {s.name for s in tr.spans()}
    md = res.decision["measured"]["delivery"]
    assert md["fwd"]["nnz"] == hg.nnz and md["total_bytes"] > 0


# -- fault tolerance and the serving front-end on the card ------------------

def _values_equal(key, got, want):
    from repro_torch.launch.serve_hypergraph import agrees

    return agrees(key, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("make,leaves", [
    (lambda h: pagerank_spec(h, iters=10), 3),
    (lambda h: shortest_paths_spec(h, 0, 12), 2),
])
def test_cuda_checkpoint_kill_and_resume_is_bitwise(card, tmp_path, make,
                                                    leaves):
    """A fused run killed after its first snapshot and resumed by a
    fresh Engine equals the uninterrupted run bit for bit, its trace
    too; the resumed run launches K1 only for the pairs it runs."""
    from repro_torch.faults import FaultInjector, InjectedFault

    spec = make(_card_hg(card))
    base = Engine(device=card, delivery="pallas_fused",
                  collect_stats=True).run(spec)
    ck = str(tmp_path / "ck")
    inj = FaultInjector.from_json({"rules": [{
        "point": "checkpoint.chunk", "trigger": "nth", "n": 1,
        "error": "fatal"}]})
    with pytest.raises(InjectedFault):
        Engine(device=card, delivery="pallas_fused", collect_stats=True,
               fault_injector=inj).run(spec, checkpoint_every=3,
                                       checkpoint_dir=ck)
    eng = Engine(device=card, delivery="pallas_fused", collect_stats=True)
    before = deliver_fused_cuda.launches
    res = eng.run(spec, checkpoint_every=3, checkpoint_dir=ck)
    torch.cuda.synchronize()
    m = res.decision["measured"]
    assert m["resumed_from"] == 3
    assert deliver_fused_cuda.launches - before == m["pairs_run"] * leaves
    for a, b in zip(tree_leaves(res.value), tree_leaves(base.value)):
        assert a.device.type == "cuda"
        assert _same_bits(a.cpu().numpy(), b.cpu().numpy())
    for a, b in zip(res.superstep_stats, base.superstep_stats):
        assert torch.equal(a, b)


def _front(eng, hg, **kw):
    from repro_torch.serve import Frontend

    fe = Frontend(eng, max_batch=8, max_delay_ms=2.0, **kw)
    fe.register("sssp", shortest_paths_spec(hg, 0, 12))
    fe.register("ppr", random_walk_spec(hg, iters=12))
    return fe


def _mixed_trace(n, n_vertices, seed=0):
    rng = np.random.default_rng(seed)
    return [("sssp" if rng.random() < 0.6 else "ppr",
             int(rng.integers(0, n_vertices))) for _ in range(n)]


@pytest.mark.cuda
def test_cuda_frontend_equals_sequential_compiled_runs(card):
    from repro_torch.serve import warm

    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused")
    fe = _front(eng, hg)
    warm(eng, [fe.compiled("sssp"), fe.compiled("ppr")], batch_sizes=(8,),
         queries=[0, 0])
    captures = eng.cache_stats()["traces"]
    trace = _mixed_trace(40, hg.n_vertices)
    try:
        fe.start()
        futs = [fe.submit(k, query=q) for k, q in trace]
        served = [f.result(timeout=300) for f in futs]
    finally:
        fe.close()
    assert eng.cache_stats()["traces"] == captures  # the worker replayed
    for (key, q), res in zip(trace, served):
        assert tree_leaves(res.value)[0].device.type == "cuda"
        assert _values_equal(key, res.value,
                             fe.compiled(key).run(query=q).value), (key, q)
    assert fe.stats()["completed"] == len(trace)


@pytest.mark.cuda
def test_cuda_submit_from_the_main_thread_during_the_first_capture(
        card, monkeypatch):
    """The worker's first flush captures its CUDA graph (no warm); the
    main thread submits, and queues work of its own on the card on a
    stream of its own, while the capture is open.  The capture holds,
    and every request is served.  (Work on the legacy default stream can
    void the capture: "operation not permitted when stream is
    capturing".)"""
    import threading

    from repro_torch.core import serving

    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused")
    fe = _front(eng, hg)
    opened, resume = threading.Event(), threading.Event()
    pair = serving._Executable.pair

    def pausing_pair(self):
        if torch.cuda.is_current_stream_capturing() and not opened.is_set():
            opened.set()
            resume.wait(timeout=60)
        return pair(self)

    monkeypatch.setattr(serving._Executable, "pair", pausing_pair)
    try:
        fe.start()
        first = fe.submit("sssp", query=3)
        assert opened.wait(timeout=120), "the worker never captured"
        more = [fe.submit("sssp", query=q) for q in (7, 11)]
        with torch.cuda.stream(torch.cuda.Stream(card)):
            side = torch.ones(1 << 16, device=card).sum().item()
        resume.set()
        served = [f.result(timeout=300) for f in [first] + more]
    finally:
        resume.set()
        fe.close()
    assert side == float(1 << 16)
    for q, res in zip((3, 7, 11), served):
        assert _values_equal("sssp", res.value,
                             fe.compiled("sssp").run(query=q).value)


@pytest.mark.cuda
def test_cuda_results_of_two_flushes_do_not_alias(card):
    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused")
    fe = _front(eng, hg)
    a = [fe.submit("sssp", query=q) for q in (0, 1)]
    fe.pump(drain=True)
    kept = [f.result(timeout=0).value[0].clone() for f in a]
    b = [fe.submit("sssp", query=q) for q in (500, 900)]
    fe.pump(drain=True)
    (exe,) = [e for e in eng._exec_cache.values() if e.batch_pad == 8]
    bufs = {t.untyped_storage().data_ptr()
            for t in tree_leaves(exe.state)}
    for f, k in zip(a, kept):
        got = f.result(timeout=0).value[0]
        assert torch.equal(got, k)
        assert got.untyped_storage().data_ptr() not in bufs
    assert not torch.equal(a[0].result(timeout=0).value[0],
                           b[0].result(timeout=0).value[0])


@pytest.mark.cuda
@pytest.mark.parametrize("point", ["execute", "layout.build"])
def test_cuda_fatal_fault_raises_typed_with_no_degrade(card, point):
    """A permanent injected fault on the card reaches the request as its
    typed error (after the front-end's bisect); no xla twin serves it."""
    from repro_torch.faults import FaultInjector, InjectedFault, PoisonQuery

    inj = FaultInjector.from_json(
        {"rules": [{"point": point, "error": "fatal"}]})
    eng = Engine(device=card, delivery="pallas_fused", fault_injector=inj)
    hg = _card_hg(card)
    degraded0 = eng.metrics.counter("faults.delivery_degraded").value
    with pytest.raises(InjectedFault, match=point):
        eng.compile(shortest_paths_spec(hg, 0, 8)).run(query=2)
    fe = _front(eng, hg)
    futs = [fe.submit("sssp", query=q) for q in range(4)]
    fe.pump(drain=True)
    for f in futs:
        err = f.exception(timeout=0)
        assert isinstance(err, PoisonQuery)
        assert isinstance(err.__cause__, InjectedFault)
    assert eng.metrics.counter("faults.delivery_degraded").value == degraded0


@pytest.mark.cuda
def test_cuda_store_records_graphs_and_a_recorded_boot_captures_once(
        card, tmp_path):
    """Records on the card: the parent's warm captures and writes one
    record a path; a second Engine boots under the sentinel (its
    captures expected), and serving after it captures nothing."""
    from repro_torch.analysis import assert_no_retrace
    from repro_torch.serve import DiskExecutableCache, warm

    hg = _card_hg(card)
    specs = [shortest_paths_spec(hg, 0, 12), random_walk_spec(hg, iters=12)]

    def engine():
        return Engine(device=card, delivery="pallas_fused",
                      disk_cache=DiskExecutableCache(tmp_path, device=card))

    parent = engine()
    rep = warm(parent, specs, batch_sizes=(8,), queries=[0, 0])
    assert rep["compiled"] == 4 and rep["traces"] == 4
    assert {p["executable"] for per in rep["paths"].values()
            for p in per.values()} == {"graph"}
    eng = engine()
    rep = warm(eng, specs, batch_sizes=(8,), queries=[0, 0],
               require_no_retrace=True)
    assert rep["from_disk"] == 4 and rep["traces"] == 4
    with assert_no_retrace(eng):
        for spec in specs:
            got = eng.compile(spec).run_batch(np.arange(5)).value
            want = parent.compile(spec).run_batch(np.arange(5)).value
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_compile_aot_fault_raises_with_no_plain_fallback(card, tmp_path):
    from repro_torch.faults import FaultInjector, InjectedFault
    from repro_torch.serve import DiskExecutableCache

    inj = FaultInjector.from_json(
        {"rules": [{"point": "compile.aot", "error": "fatal"}]})
    eng = Engine(device=card, delivery="pallas_fused", fault_injector=inj,
                 disk_cache=DiskExecutableCache(tmp_path, device=card))
    with pytest.raises(InjectedFault, match="compile.aot"):
        eng.compile(shortest_paths_spec(_card_hg(card), 0, 8)).run(query=1)
    assert eng.cache_stats()["entries"] == 0
    assert eng.disk_cache.stats()["entries"] == 0


@pytest.mark.cuda
def test_cuda_pipe_thread_host_copy_while_the_worker_captures(
        card, monkeypatch):
    """The replica's pipe thread copies a result to the host on a stream
    of its own while the front-end's worker holds a capture open: the
    copy is right and the capture holds."""
    import threading

    from repro_torch.core import serving
    from repro_torch.serve.replica import _to_host

    hg = _card_hg(card)
    eng = Engine(device=card, delivery="pallas_fused")
    fe = _front(eng, hg)
    opened, resume = threading.Event(), threading.Event()
    pair = serving._Executable.pair

    def pausing_pair(self):
        if torch.cuda.is_current_stream_capturing() and not opened.is_set():
            opened.set()
            resume.wait(timeout=60)
        return pair(self)

    monkeypatch.setattr(serving._Executable, "pair", pausing_pair)
    row = torch.arange(1 << 16, dtype=torch.float32, device=card)
    torch.cuda.synchronize(card)
    copied = []
    try:
        fe.start()
        first = fe.submit("sssp", query=3)
        assert opened.wait(timeout=120), "the worker never captured"
        pipe = threading.Thread(target=lambda: copied.append(_to_host(row)))
        pipe.start()
        pipe.join(timeout=60)
        resume.set()
        served = first.result(timeout=300)
    finally:
        resume.set()
        fe.close()
    assert isinstance(copied[0], np.ndarray)
    assert np.array_equal(copied[0], np.arange(1 << 16, dtype=np.float32))
    assert _values_equal("sssp", served.value,
                         fe.compiled("sssp").run(query=3).value)


@pytest.mark.cuda
def test_cuda_capture_holds_while_a_dead_engine_awaits_collection(
        card, monkeypatch):
    """A dead cycle holds a whole Engine with captured graphs; it is
    dropped inside the next capture with the collector's threshold at 1,
    so a cyclic collection would free it there.  The capture keeps the
    collector off: the compiled run captures and equals ``Engine.run``."""
    import gc

    from repro_torch.core import serving

    hg = _card_hg(card)
    old = Engine(device=card, delivery="pallas_fused")
    old.compile(shortest_paths_spec(hg, 0, 8)).run()
    keep = [old]
    del old
    pair = serving._Executable.pair
    threshold = gc.get_threshold()

    def dropping_pair(self):
        if torch.cuda.is_current_stream_capturing() and keep:
            cycle = [keep.pop()]
            cycle.append(cycle)
            del cycle
            gc.set_threshold(1)
        return pair(self)

    monkeypatch.setattr(serving._Executable, "pair", dropping_pair)
    spec = pagerank_spec(hg, iters=3)
    try:
        res = Engine(device=card, delivery="pallas_fused").compile(spec).run()
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert not keep and res.decision["measured"]["graph"]
    want = Engine(device=card, delivery="pallas_fused").run(spec)
    for a, b in zip(res.value, want.value):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_host_copy_stream_is_never_the_capture_stream(card):
    """Torch hands out streams of one priority from a ring of 32, and
    ``torch.cuda.graph`` captures on a default-priority one: a pipe
    thread's copy stream is a high-priority one, so however many threads
    make theirs, none is the stream a capture is open on."""
    import threading

    from repro_torch.serve import replica

    graph = torch.cuda.CUDAGraph()
    x = torch.zeros(4, device=card)
    with torch.cuda.graph(graph):
        x.add_(1)
    capture = torch.cuda.graph.default_capture_stream.cuda_stream
    row = torch.arange(8, dtype=torch.float32, device=card)
    streams = []

    def copy():
        assert np.array_equal(replica._to_host(row), np.arange(8))
        streams.append(replica._HOST.stream.cuda_stream)

    for _ in range(40):
        t = threading.Thread(target=copy)
        t.start()
        t.join(timeout=60)
    assert len(streams) == 40 and capture not in streams


@pytest.mark.cuda
def test_cuda_pool_of_two_survives_kill9(card, tmp_path):
    """Two replica processes on the card behind the router, booted from
    the parent's records: kill -9 of one mid-replay, every request
    resolves, results arrive as numpy and agree with the parent's
    sequential runs, no replica captures after its warm, and the
    respawn boots from the records."""
    import os

    from repro_torch.faults import FrontendClosed, ReplicaLost
    from repro_torch.launch import serve_hypergraph as launcher
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve import (
        MAX_FAILOVERS,
        DiskExecutableCache,
        ProcessReplica,
        ReplicaConfig,
        Router,
        warm,
    )

    store = str(tmp_path / "store")
    kwargs = {"regime": "dblp", "scale": 0.05, "seed": 0, "iters": 12}
    paths = launcher.build_paths(**kwargs, device=card)
    parent = Engine(device=card,
                    disk_cache=DiskExecutableCache(store, device=card))
    warm(parent, list(paths["specs"].values()),
         batch_sizes=launcher.batch_buckets(8), queries=[0, 0])
    cfg = ReplicaConfig(
        builder="repro_torch.launch.serve_hypergraph:build_paths",
        kwargs=kwargs, cache_dir=store, max_batch=8, device="cuda",
        exec_cache_bytes=2**30)
    spawned = []

    def factory(i):
        spawned.append(ProcessReplica(i, cfg))
        return spawned[-1]

    router = Router(factory, 2, heartbeat_timeout_ms=2000.0,
                    max_in_flight=8, registry=MetricsRegistry()).start()
    try:
        router.wait_ready(timeout_s=240)
        trace = _mixed_trace(64, paths["hg"].n_vertices)
        futs = [router.submit(k, query=q) for k, q in trace]
        victim = router.slots[0].handle
        os.kill(victim.pid, 9)
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=240))
            except (ReplicaLost, FrontendClosed) as err:
                out.append(err)
        lost = [r for r in out if isinstance(r, Exception)]
        assert len(lost) <= MAX_FAILOVERS
        st = router.stats()
        assert st["in_flight"] == 0 and st["pending"] == 0
        assert st["deaths"] >= 1 and st["respawns"] >= 1
        router.wait_ready(timeout_s=240)
        assert router.stats()["per_replica"][0]["boot"]["from_disk"] == 4
        for (key, q), r in zip(trace, out):
            if isinstance(r, Exception):
                continue
            assert all(isinstance(x, np.ndarray)
                       for x in tree_leaves(r.value))
            want = parent.compile(paths["specs"][key]).run(query=q).value
            assert _values_equal(key, r.value, want), (key, q)
        import time

        time.sleep(0.3)
        for p in router.stats()["per_replica"]:
            assert p["replica_counts"]["traces"] == p["boot"]["engine_traces"]
    finally:
        router.close()
        for handle in spawned:
            handle.stop(force=True)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["replicated", "sharded"])
def test_cuda_distributed_world1_equals_local_and_captures(card, backend,
                                                           tmp_path):
    # One card gives one NCCL rank: the distributed pair, K1 on the
    # rank's shard layouts and its collectives captured in one graph.
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_local_group, make_host_mesh

    hg = powerlaw_hypergraph(3000, 2000, mean_cardinality=5, seed=11,
                             device=card)
    spec = shortest_paths_spec(hg, 0)
    local = Engine(device=card, delivery="pallas_fused",
                   collect_stats=True).run(spec)
    init_local_group(0, 1, str(tmp_path / "store"), "cuda")
    try:
        eng = Engine(mesh=make_host_mesh(1), device=card, backend=backend,
                     delivery="pallas_fused", collect_stats=True,
                     partition_strategy="random_vertex_cut")
        deliver_fused_cuda.launches = 0
        res = eng.run(spec)
        assert deliver_fused_cuda.launches > 0
        for a, b in zip(res.value + res.superstep_stats,
                        local.value + local.superstep_stats):
            assert torch.equal(a, b)
        comp = eng.compile(spec)
        comp.run()
        got = comp.run()
        assert got.decision["measured"]["graph"]
        for a, b in zip(got.value, local.value):
            assert torch.equal(a, b)
        batch = comp.run_batch(np.asarray([0, 5, 7]))
        for i, q in enumerate((0, 5, 7)):
            want = comp.run(query=q).value
            for a, b in zip(batch.value, want):
                assert torch.equal(a[i], b)
    finally:
        dist.destroy_process_group()


# -- static analysis on the card: the shared-memory budgets ---------------

KERNEL_SOURCES = (("deliver_fused", "deliver_fused.cu"), ("isect", "isect.cu"),
                  ("segsum", "segsum.cu"), ("flash", "flash.cu"))


@pytest.mark.cuda
def test_cuda_k2b_at_the_largest_block_e_the_geometry_admits(card):
    """bfloat16 D = 8 (``k2b_kernel<__nv_bfloat16, 8, false>``, the
    template with the most static shared memory) at the largest
    ``block_e`` ``k2b_geometry`` admits: the launch fits the opt-in limit
    beside the static arrays and equals the plain version bitwise
    (integer payloads).  With the 9 KB reserve taken before, the
    geometry admitted blocks 48 bytes larger than the card gives."""
    from repro_torch.analysis import shapes

    rng = np.random.default_rng(26)
    e, n = 50_000, 10_000
    ids = torch.sort(torch.as_tensor(rng.integers(0, n, e).astype(np.int32),
                                     device=card)).values
    offsets = torch.searchsorted(
        ids, torch.arange(n + 1, dtype=torch.int32, device=card)).to(
        torch.int32)
    msgs = torch.as_tensor(rng.integers(-4, 5, (e, 8)).astype(np.float32),
                           device=card).to(torch.bfloat16)
    be = shapes._largest_admitted(
        lambda b: segsum_module.k2b_geometry(e, n, 8, 2, b, True))
    geo = segsum_module.k2b_geometry(e, n, 8, 2, be, True)
    static = shapes.static_bytes("segsum.cu", "k2b_kernel",
                                 ("__nv_bfloat16", "8", "false"))
    assert geo.items == be and geo.vec == 8
    assert geo.smem_bytes + static <= shapes.OPTIN_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        segsum_module.k2b_geometry(e, n, 8, 2, be + 4, True)
    before = segsum_sorted_cuda.launches
    got = segsum_sorted_cuda(msgs, offsets, n, block_e=be)
    torch.cuda.synchronize()
    assert segsum_sorted_cuda.launches == before + 1
    assert torch.equal(got, segsum_sorted_plain(msgs, offsets, n))


@pytest.mark.cuda
def test_cuda_shared_memory_limits_equal_the_model(card):
    from repro_torch.analysis import shapes

    assert shapes.device_limits(card) == (shapes.DEFAULT_BYTES,
                                          shapes.OPTIN_BYTES)


@pytest.mark.cuda
def test_cuda_ptxas_static_shared_memory_equals_the_model(card):
    """Every entry function of the four builds, with ``ptxas``'s static
    bytes equal to the model's (read from the sources' arrays)."""
    from repro_torch.analysis import shapes

    logs = {src: _nvcc.build_log(name, (src,))
            for name, src in KERNEL_SOURCES}
    assert all(shapes.ptxas_static_smem(t) for t in logs.values())
    bad = shapes.check_ptxas(logs)
    assert bad == [], [f.scope + ": " + f.message for f in bad]


@pytest.mark.cuda
def test_cuda_kernels_at_their_worst_geometry_equal_plain(card):
    """Each kernel once at the worst geometry its budget admits (K1 at
    span ``_MAX_SPAN``, K2a at ``block_n`` 4,096 and at the widest tile,
    K2b at the largest ``block_e``, K3a at its widest rings, K4 at head
    dim 256): bitwise on integer payloads, K4 within this file's
    attention tolerance."""
    from repro_torch.analysis import shapes

    cases = shapes.worst_launches(card)
    assert sorted({c[0] for c in cases}) == ["K1", "K2a", "K2b", "K3a",
                                             "K4"]
    for kid, label, kernel, plain in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        if kid == "K4":
            tol = 2e-5 if got.dtype == torch.float32 else 3e-2
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        else:
            assert torch.equal(got, want), (kid, label)


@pytest.mark.cuda
def test_cuda_shape_budget_audit_on_the_card(card):
    """The ``shapes`` pass with the fused lowering on the card (K1)."""
    from repro_torch.analysis import shapes

    before = deliver_fused_cuda.launches
    assert shapes.shape_budget_audit(device=card) == []
    assert deliver_fused_cuda.launches > before
