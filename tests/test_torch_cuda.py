"""The port on the card: the fused delivery kernel (per class and one
launch per leaf, wide messages too), the bitset intersection kernels
(their run cache too), the Engine's paths through them (``run``,
``analyze``, and ``compile``'s CUDA-graph replay of one superstep pair,
``run`` and ``run_batch``), and the segment-sum and attention kernels
through their entry points (K4 with K/V of fewer heads too), with one
full-width llama3.2-1b prefill through K4 against its plain route; K4's
backward kernels on both routes (bfloat16 on the tensor cores, the FMA
tiles) against their plain version, and one smoke training step on the
card against the same step on the CPU; the GNN side's K2a route
(``SegmentSumFn`` forward and gradient, ``mp_segment_sum``) and one
step of each GNN smoke config against the CPU's; the recsys side: K4
bidirectional in float32 at BERT4Rec's attention shape (forward and
backward), ``embedding_bag`` on K2a, and one BERT4Rec smoke step against
the CPU's.

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
    flash_backward_cuda,
    flash_bwd_plan,
    flash_cuda,
    flash_plain,
    flash_plain_backward,
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


def _segsum_f64(msgs, ids, n):
    """The exact sum, as far as float64 goes: ``msgs`` summed by ``ids``
    with an ``index_add_`` in float64, ids outside ``[0, n)`` dropped.
    (A float32 reference strays from it further than K2a does.)"""
    keep = (ids >= 0) & (ids < n)
    out = torch.zeros(n, msgs.shape[1], dtype=torch.float64,
                      device=msgs.device)
    return out.index_add_(0, ids[keep].long(), msgs[keep].double())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 64, 100, 256, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_segsum_kernels_equal_plain(card, dtype, d):
    """Both forms against the float64 sum of the same messages under
    ``_segsum_tol``.  K2a with block_e = 300: every tile of 128 rows
    splits into several work items; a long row and heavy tiles (the
    last one partial) run its combine tree; D = 256 and 1000 cut the
    columns into slices; shuffled ids too."""
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
    want = _segsum_f64(msgs, ids, n)
    torch.testing.assert_close(got.double(), want, **tol)
    torch.testing.assert_close(got_s.double(), want, **tol)
    assert torch.equal(got_s, again)                   # K2b: same bits
    # Ids outside [0, N) are dropped: the same sums as without them.
    keep = (ids >= 0) & (ids < n)
    torch.testing.assert_close(
        got.double(), _segsum_f64(msgs[keep], ids[keep], n), **tol)
    perm = torch.as_tensor(rng.permutation(e), device=card)
    mp, ip = msgs[perm].contiguous(), ids[perm].contiguous()
    torch.testing.assert_close(
        segment_sum_mxu(mp, ip, n, block_e=300).double(),
        _segsum_f64(mp, ip, n), **tol)


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


def _kernel_names(call, runs=2):
    """The CUDA kernels ``call`` launches, by the profiler's names: the
    card synchronised first, CPU and CUDA activity (as ``chip_smoke``'s
    ``profiled``), and the call made ``runs`` times inside the session
    (a kernel the tracer misses once is still seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _flash_qkv(rng, dev, dtype, sq, sk, d, b=2, h=3):
    return tuple(torch.as_tensor(
        rng.standard_normal((b, h, s, d)).astype(np.float32) * scale,
        device=dev).to(dtype) for s, scale in ((sq, 0.3), (sk, 0.3),
                                               (sk, 1.0)))


# Head dims 8, 40, 64, 96, 128 and 256 (every wgmma width, padded and
# not), and 20 (no multiple of 8: the element-wise tile loads); float32 D
# 8, 32, 40, 64, 96 and 128 on the three-pass TF32 route (8 keys, 200 in
# one 32- or 64-key tile sequence, 256, 257), D 20, 36 and 256 on the FMA
# tiles.
@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(200, 64), (128, 40), (256, 256), (70, 8),
                                 (333, 96), (257, 128), (90, 20), (8, 8),
                                 (200, 32), (256, 32), (257, 64), (100, 36)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_kernel_equals_plain(card, causal, dtype, s, d):
    rng = np.random.default_rng(s + d)
    q, k, v = _flash_qkv(rng, card, dtype, s, s, d)
    if dtype == torch.float32:
        assert flash_plan(d, dtype).kernel == (
            "tf32" if d % 8 == 0 and d <= 128 else "fma")
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
# query and one key, and Sk no multiple of the 128- or 64-key tile; for
# float32's TF32 route also Sk 8, 200, 256 and 257 against its 32- and
# 64-key tiles, and causal Sq != Sk at D 8, 32 and 64.
@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal", [
    (100, 300, 64, True), (300, 100, 64, True), (300, 129, 128, True),
    (1, 1, 64, True), (1, 1, 128, False), (1, 77, 256, False),
    (5, 200, 256, True), (64, 130, 64, False), (200, 65, 256, False),
    (129, 257, 96, True), (8, 8, 8, False), (200, 200, 32, False),
    (64, 256, 32, True), (300, 257, 64, True), (257, 100, 32, True),
    (33, 8, 8, True),
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
@pytest.mark.parametrize("d", [32, 64])
def test_cuda_flash_float32_unaligned_rows_equal_plain(card, d):
    """Float32 operands 4 bytes past a 16-byte boundary: the TF32 kernels
    load and store them element by element, forward and backward."""
    rng = np.random.default_rng(d + 7)
    shape = (1, 2, 150, d)
    n = int(np.prod(shape))
    q, k, v, dout = (torch.as_tensor(rng.standard_normal(n + 1).astype(
        np.float32) * scale, device=card)[1:].view(shape)
        for scale in (0.3, 0.3, 1.0, 1.0))
    assert q.data_ptr() % 16 and q.is_contiguous()
    assert flash_plan(d, torch.float32).kernel == "tf32"
    assert flash_bwd_plan(d, torch.float32).kernel == "tf32"
    out, lse = flash_cuda(q, k, v, causal=True, return_lse=True)
    p_out, p_lse = flash_plain(q, k, v, causal=True, return_lse=True)
    torch.testing.assert_close(out, p_out, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=1e-5)
    got = flash_backward_cuda(q, k, v, out, lse, dout, causal=True)
    want = flash_plain_backward(q, k, v, p_out, p_lse, dout, causal=True)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert _rel_max(g, w) <= 1e-4, (name, _rel_max(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_flash_float32_tf32_is_bitwise_repeatable(card, d):
    """The three-pass TF32 forward, output and lse: no atomics, two
    launches give the same bits."""
    assert flash_plan(d, torch.float32).kernel == "tf32"
    rng = np.random.default_rng(d + 1)
    q, k, v = _flash_qkv(rng, card, torch.float32, 700, 700, d)
    first = flash_cuda(q, k, v, causal=True, return_lse=True)
    second = flash_cuda(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


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
    """``flash_plan``'s shared memory is what the source launches with,
    and its route the kernel the profiler sees launched."""
    lib = flash_lib()
    for dtype, code in FLASH_DTYPES.items():
        for d in range(1, 257):
            assert lib.flash_smem_bytes(d, code) == flash_plan(
                d, dtype).smem_bytes, (dtype, d)
        assert lib.flash_smem_bytes(257, code) == -1
    names = {"wgmma": "flash_wgmma_kernel<", "tf32": "flash_tf32_kernel<",
             "fma": "flash_kernel<"}
    for dtype, d in ((torch.float32, 8), (torch.float32, 32),
                     (torch.float32, 64), (torch.float32, 128),
                     (torch.float32, 36), (torch.float32, 256),
                     (torch.bfloat16, 64)):
        q, k, v = _flash_qkv(np.random.default_rng(d), card, dtype, 70, 70,
                             d)
        seen = _kernel_names(lambda: flash_cuda(q, k, v, causal=True))
        launched = {n for n, part in names.items()
                    for key in seen if part in key}
        assert launched == {flash_plan(d, dtype).kernel}, (dtype, d,
                                                            launched)


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
    (64, 0.002, "measured"), (64, 0.05, "measured"),
    (1, 0.001, "xla"), (64, 0.001, "measured")])
def test_cuda_select_delivery_names_the_measured_term(card, d, nnz_scale,
                                                      pick):
    """Rows up to 64 bytes take the fixed term; wider rows (D = 64,
    256 bytes) are contested: ``Engine.resolve``'s pick follows one
    delivery pair timed on each lowering (``measured_pick``: ``xla`` only
    where it leads by more than the margin), both times in ``why``."""
    from repro_torch.algorithms import AlgorithmSpec
    from repro_torch.core.executor import H100_FUSED_MIN_NNZ, measured_pick
    from repro_torch.data import make_dataset

    hg = make_dataset("dblp", nnz_scale, seed=0, device=card)
    prog = Program(procedure=None, combiner="sum")
    spec = AlgorithmSpec(hg0=hg, initial_msg=torch.zeros(d), v_program=prog,
                         he_program=prog, max_iters=1, extract=lambda o: o)
    resolved, _, decision = Engine(device=card).resolve(spec)
    got, why = resolved.delivery, decision["delivery"]
    assert why["lowering"] == "cuda"
    assert why["min_nnz"] == H100_FUSED_MIN_NNZ
    if pick == "measured":
        times = why["measured_ms"]
        assert all(t > 0 for t in times.values())
        assert got == measured_pick(times["xla"], times["pallas_fused"])
        assert "contested" in why["reason"]
        return
    assert got == pick
    assert "measured_ms" not in why
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


@pytest.mark.cuda
def test_cuda_partitioned_lm_step_on_a_1x1_mesh_equals_plain(card,
                                                             tmp_path):
    # The dense LM's partitioned train step (DTensor placements, K4 on
    # local heads through local_map, the vocab-parallel CE) on one NCCL
    # rank: the plain step's loss, grad_norm and parameters, bitwise,
    # with K4's kernels, forward and backward, launched.
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import init_local_group, make_mesh
    from repro_torch.launch.tasks import build_task
    from repro_torch.train.tree import leaves

    spec = get_config("llama3.2-1b", smoke=True)
    shape = dataclasses.replace(spec.shape("train_4k"), dims={
        "seq_len": 64, "global_batch": 4, "accum_steps": 2})
    cfg, plain = ltrain.build("llama3.2-1b", smoke=True, seed=0,
                              device=card)
    _, fresh = ltrain.build("llama3.2-1b", smoke=True, seed=0, device=card)
    batch = ltrain.synthetic_batch(cfg.vocab, 4, 64, 0, 0, card)
    plain, want = ltrain.make_step(cfg, accum_steps=2)(plain, batch)
    init_local_group(0, 1, str(tmp_path / "store"), "cuda")
    try:
        task = build_task(spec, shape, make_mesh((1, 1)))
        assert task.partitioned
        flash_cuda.launches = flash_backward_cuda.launches = 0
        state, got = task.run(fresh, batch)
        torch.cuda.synchronize()
        assert flash_cuda.launches == 2 * cfg.n_layers
        assert flash_backward_cuda.launches == 2 * cfg.n_layers
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(got[key].full_tensor(), want[key]), key
        for a, b in zip(leaves(state), leaves(plain)):
            assert torch.equal(a.full_tensor(), b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_partitioned_bert4rec_on_a_1x1_mesh_equals_plain(card,
                                                             tmp_path):
    # BERT4Rec's partitioned cells (the vocab-parallel lookups, K4 on
    # each rank's own rows through local_map, the top-100 of each
    # device's own rows) on one NCCL rank at the smoke config: the plain
    # step's loss, grad_norm and parameters, and the plain serving and
    # retrieval top-100, bitwise, with K4's kernels launched.
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_local_group, make_mesh
    from repro_torch.launch.tasks import build_task
    from repro_torch.models.recsys import bert4rec
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    spec = get_config("bert4rec", smoke=True)
    cfg = spec.model
    b, s = 16, cfg.max_seq
    gen = torch.Generator(device=card).manual_seed(0)
    items = torch.randint(1, cfg.n_items + 1, (b, s), generator=gen,
                          device=card, dtype=torch.int32)
    batch = {"items": items,
             "masked_pos": torch.argsort(torch.rand(
                 b, s, generator=gen, device=card))[:, :4].int(),
             "labels": items[:, :4].clone(),
             "negatives": torch.randint(1, cfg.n_items + 1, (8192,),
                                        generator=gen, device=card,
                                        dtype=torch.int32)}
    cand = torch.randint(1, cfg.n_items + 1, (1000,), generator=gen,
                         device=card, dtype=torch.int32)

    def params():
        return bert4rec.init_params(
            torch.Generator(device=card).manual_seed(1), cfg)

    plain, want = make_train_step(
        lambda p, x: bert4rec.loss_sampled(p, cfg, x), AdamWConfig())(
            init_train_state(params()), batch)
    p = params()
    with torch.no_grad():
        serve_want = torch.topk(bert4rec.serve_score(p, cfg, items), 100)
        retr_want = torch.topk(bert4rec.retrieval_score(p, cfg, items[:1],
                                                        cand), 100)
    init_local_group(0, 1, str(tmp_path / "store"), "cuda")
    try:
        mesh = make_mesh((1, 1))
        task = build_task(spec, dataclasses.replace(
            spec.shape("train_batch"), dims={"batch": b}), mesh)
        assert task.partitioned
        flash_cuda.launches = flash_backward_cuda.launches = 0
        state, got = task.run(init_train_state(params()), batch)
        torch.cuda.synchronize()
        assert flash_cuda.launches == flash_backward_cuda.launches == 2
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(got[key].full_tensor(), want[key]), key
        for x, y in zip(leaves(state), leaves(plain)):
            assert torch.equal(x.full_tensor(), y)
        serve = build_task(spec, dataclasses.replace(
            spec.shape("serve_p99"), dims={"batch": b}), mesh)
        retrieve = build_task(spec, dataclasses.replace(
            spec.shape("retrieval_cand"), dims={"batch": 1,
                                                "n_candidates": 1000}),
            mesh)
        for (vals, ids), (w_vals, w_ids) in (
                (serve.run(p, items), serve_want),
                (retrieve.run(p, items[:1], cand), retr_want)):
            assert torch.equal(vals.full_tensor(), w_vals)
            assert torch.equal(ids.full_tensor(), w_ids)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gat-cora", "pna", "nequip", "mace"])
def test_cuda_partitioned_gnn_step_on_a_1x1_mesh_equals_plain(card, tmp_path,
                                                              arch):
    # A GNN pjit cell's partitioned train step (the node gathers, the
    # message sums on K2a and the max / min merges under local_map) on
    # one NCCL rank at the smoke config, on 8 molecules of 6 nodes and
    # 12 edges: the plain step's loss, grad_norm and parameters within
    # 5e-4 (K2a's atomics move the last bits between runs), with K2a
    # launched as often as in the plain step.
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_local_group, make_mesh
    from repro_torch.launch.tasks import build_task
    from repro_torch.models.gnn import equivariant, gat, pna, random_graph
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    spec = get_config(arch, smoke=True)
    cfg = spec.model
    mod = {"gat-cora": gat, "pna": pna}.get(arch, equivariant)
    if mod is equivariant:
        g = random_graph(48, 96, with_positions=True,
                         n_species=cfg.n_species, n_graphs=8, seed=4,
                         device=card)
        g = dataclasses.replace(g, labels=torch.randn(
            8, generator=torch.Generator(device=card).manual_seed(2),
            device=card))
    else:
        g = random_graph(48, 96, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                         n_graphs=8, seed=4, device=card)
    shape = dataclasses.replace(spec.shape("molecule"), dims={
        "n_nodes": 6, "n_edges": 12, "batch": 8,
        "d_feat": getattr(cfg, "d_in", 16),
        "n_classes": getattr(cfg, "n_classes", 8)})

    def params():
        return mod.init_params(torch.Generator(device=card).manual_seed(0),
                               cfg)

    segsum_cuda.launches = 0
    plain, want = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b),
                                  AdamWConfig())(init_train_state(params()),
                                                 g)
    torch.cuda.synchronize()
    plain_launches = segsum_cuda.launches
    init_local_group(0, 1, str(tmp_path / "store"), "cuda")
    try:
        task = build_task(spec, shape, make_mesh((1, 1)))
        assert task.partitioned
        segsum_cuda.launches = 0
        state, got = task.run(init_train_state(params()), g)
        torch.cuda.synchronize()
        assert segsum_cuda.launches == plain_launches > 0
        loss = float(want["loss"])
        assert abs(float(got["loss"].full_tensor()) - loss) <= 5e-4 * max(
            1.0, abs(loss))
        assert abs(float(got["grad_norm"].full_tensor())
                   - float(want["grad_norm"])) <= 5e-4 * float(
                       want["grad_norm"])
        for x, y in zip(leaves(state.params), leaves(plain.params)):
            x = x.full_tensor()
            assert (x - y).abs().max() <= 5e-4 * y.abs().max()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,moe", [
    ("qwen3-moe-235b-a22b", {"n_groups": 4}),
    ("llama4-maverick-400b-a17b", {})])
def test_cuda_partitioned_moe_step_on_a_1x1_mesh_equals_plain(card, tmp_path,
                                                              arch, moe):
    # The MoE LM's partitioned train step (the routing and the experts
    # on local tensors through local_map, the router's sums and the
    # combine as DTensors) on one NCCL rank: the plain step's loss,
    # grad_norm and parameters, bitwise (the combine adds each token's
    # slots in a fixed order), with K4 launched on the global layers.
    # qwen3-moe routes 4 groups of a micro-batch's 512 tokens; llama4
    # its one global layer of four and a shared expert.
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.mesh import init_local_group, make_mesh
    from repro_torch.launch.tasks import build_task
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.train.tree import leaves

    spec = get_config(arch, smoke=True)
    cfg = dataclasses.replace(spec.model, moe=dataclasses.replace(
        spec.model.moe, **moe))
    spec = dataclasses.replace(spec, model=cfg)
    shape = dataclasses.replace(spec.shape("train_4k"), dims={
        "seq_len": 256, "global_batch": 4, "accum_steps": 2})

    def state():
        gen = torch.Generator(device=card).manual_seed(0)
        return init_train_state(init_params(gen, cfg))

    batch = ltrain.synthetic_batch(cfg.vocab, 4, 256, 0, 0, card)
    step = make_train_step(lambda p, b: loss_fn(p, cfg, b),
                           AdamWConfig(), 2)
    plain, want = step(state(), batch)
    n_global = sum(not cfg.kind(i)[0] for i in range(cfg.n_layers))
    init_local_group(0, 1, str(tmp_path / "store"), "cuda")
    try:
        task = build_task(spec, shape, make_mesh((1, 1)))
        assert task.partitioned
        flash_cuda.launches = flash_backward_cuda.launches = 0
        got_state, got = task.run(state(), batch)
        torch.cuda.synchronize()
        assert flash_cuda.launches == 2 * n_global
        assert flash_backward_cuda.launches == 2 * n_global
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(got[key].full_tensor(), want[key]), key
        for a, b in zip(leaves(got_state), leaves(plain)):
            assert torch.equal(a.full_tensor(), b)
    finally:
        dist.destroy_process_group()


# -- static analysis on the card: the shared-memory budgets ---------------

KERNEL_SOURCES = (("deliver_fused", "deliver_fused.cu"), ("isect", "isect.cu"),
                  ("segsum", "segsum.cu"), ("flash", "flash.cu"),
                  ("flash_bwd", "flash_bwd.cu"))


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


# K4 with K/V of fewer heads than Q (grouped-query attention): each
# block reads its KV head by index.  H:KvH of llama3.2-1b (32:8), one KV
# head (multi-query), 6:3, and D = 20 (the element-wise loads).
@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", [(32, 8), (8, 1), (6, 3)])
@pytest.mark.parametrize("s,d,causal", [(300, 64, True), (257, 128, False),
                                        (90, 20, True), (130, 256, True),
                                        (200, 32, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_gqa_equals_plain(card, dtype, s, d, causal, h, kvh):
    rng = np.random.default_rng(h * 100 + kvh + s + d)
    q = torch.as_tensor(rng.standard_normal((2, h, s, d)).astype(
        np.float32) * 0.3, device=card).to(dtype)
    k, v = (torch.as_tensor(rng.standard_normal((2, kvh, s, d)).astype(
        np.float32) * scale, device=card).to(dtype) for scale in (0.3, 1.0))
    before = flash_cuda.launches
    got = flash_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    rep = h // kvh
    kx, vx = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    for want in (flash_plain(q, k, v, causal=causal),
                 attention_ref(q, kx, vx, causal=causal)):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    if kvh > 1:  # a tiled mapping (h % KvH) would read other heads
        wrong = flash_plain(q, k.repeat(1, rep, 1, 1), v.repeat(1, rep, 1, 1),
                            causal=causal)
        assert (got.float() - wrong.float()).abs().max() > 10 * tol


@pytest.mark.cuda
def test_cuda_flash_gqa_refuses_kv_heads_that_do_not_divide(card):
    q = torch.zeros(1, 6, 16, 64, device=card)
    kv = torch.zeros(1, 4, 16, 64, device=card)
    with pytest.raises(ValueError, match="multiple of the KV heads"):
        flash_cuda(q, kv, kv)


@pytest.mark.cuda
def test_cuda_llama3_2_1b_full_width_prefill_k4_equals_plain_route(card):
    """One full-width llama3.2-1b prefill (random float32 weights, bf16
    compute, 2 x 1,024 tokens): 16 K4 launches, and the last logits
    within chip_smoke's 5e-2 of the largest magnitude of the same
    weights' prefill through ``flash_plain``, and no further from the
    float32 prefill than twice the plain route (``chip_smoke.py``'s
    ``LM_ROUTE_TOL`` says why)."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import attention
    from repro_torch.models.transformer import prefill

    cfg, params = serve.build("llama3.2-1b", smoke=False, device=card)
    prompts = serve.make_prompts(cfg, 2, 1024, device=card)
    kernel = attention.flash_attention
    try:
        with torch.no_grad():
            before = flash_cuda.launches
            got, cache = prefill(params, cfg, prompts)
            torch.cuda.synchronize()
            assert flash_cuda.launches == before + cfg.n_layers == before + 16
            attention.flash_attention = (
                lambda q, k, v, causal: flash_plain(
                    q, k, v, causal=causal, block_q=1024, block_k=1024))
            want, _ = prefill(params, cfg, prompts)
    finally:
        attention.flash_attention = kernel
    assert cache["k"].shape == (16, 2, 1024, 8, 64)
    assert cache["k"].dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert err <= 5e-2, err
    with torch.no_grad():
        ref, _ = prefill(params, dataclasses.replace(
            cfg, compute_dtype=torch.float32), prompts)
    k4_32, plain_32 = (((x.float() - ref).abs().max() / ref.abs().max())
                       .item() for x in (got, want))
    assert k4_32 <= 2 * plain_32, (k4_32, plain_32)
    del params, cache
    torch.cuda.empty_cache()


# -- K4's backward (csrc/flash_bwd.cu) -------------------------------------

def _bwd_inputs(rng, dev, dtype, b, h, kvh, s, d, causal, sk=None):
    """q, k, v, the forward's output and row lse through K4, and a dO
    (``sk`` keys, ``s`` by default)."""
    sk = s if sk is None else sk
    q = torch.as_tensor(rng.standard_normal((b, h, s, d)).astype(
        np.float32) * 0.3, device=dev).to(dtype)
    k, v = (torch.as_tensor(rng.standard_normal((b, kvh, sk, d)).astype(
        np.float32) * scale, device=dev).to(dtype) for scale in (0.3, 1.0))
    out, lse = flash_cuda(q, k, v, causal=causal, return_lse=True)
    dout = torch.as_tensor(rng.standard_normal((b, h, s, d)).astype(
        np.float32), device=dev).to(dtype)
    return q, k, v, out, lse, dout


def _rel_max(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


# MHA and GQA (llama3.2-1b's 32:8 and multi-query), head dims 8 to 256
# (both FMA tile sizes; bfloat16 D 8, 40, 64, 120 and 128 on the tensor
# cores, D 36 and 256 on the FMA units; float32 D 8, 32, 40 and 64 in
# three TF32 passes, D 36, 120, 128 and 256 on the FMA units), S ragged
# against the 32-, 64- and 128-row tiles (Sk 8, 200, 256 and 257 too),
# and causal Sq != Sk both ways.
@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (4, 1), (32, 8)])
@pytest.mark.parametrize("s,sk,d,causal", [
    (200, 200, 64, True), (70, 70, 8, True), (257, 257, 128, True),
    (130, 130, 256, True), (96, 96, 40, False), (65, 65, 256, False),
    (129, 129, 128, True), (100, 100, 36, True), (128, 128, 64, True),
    (257, 257, 120, True), (64, 192, 64, True), (300, 100, 128, True),
    (190, 70, 64, False), (8, 8, 8, False), (200, 200, 32, False),
    (256, 256, 32, True), (100, 257, 64, True), (257, 100, 32, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_equals_plain(card, dtype, s, sk, d, causal, h,
                                          kvh):
    """dQ, dK, dV of the kernels against ``flash_plain_backward`` on the
    same saved tensors: float32 within 1e-4 and bfloat16 within 2e-2 of
    each tensor's largest magnitude; one launch a call."""
    rng = np.random.default_rng(h * 10 + kvh + sk + d)
    q, k, v, out, lse, dout = _bwd_inputs(rng, card, dtype, 2, h, kvh, s, d,
                                          causal, sk=sk)
    before = flash_backward_cuda.launches
    got = flash_backward_cuda(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert flash_backward_cuda.launches == before + 1
    want = flash_plain_backward(q, k, v, out, lse, dout, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel_max(g, w) <= tol, (name, _rel_max(g, w))


# The source's flash_bwd_route codes.
BWD_ROUTES = {"fma": 0, "wgmma": 1, "tf32": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 40, "wgmma"), (torch.float32, 64, "tf32"),
    (torch.float32, 32, "tf32"), (torch.float32, 8, "tf32"),
    (torch.float32, 128, "fma"), (torch.float32, 36, "fma"),
    (torch.bfloat16, 36, "fma"), (torch.bfloat16, 256, "fma")])
def test_cuda_flash_backward_launches_its_routes_kernels(card, dtype, d,
                                                         route):
    """bfloat16 at D % 8 == 0 up to 128 runs the bf16 tensor-core
    kernels, float32 at D % 8 == 0 up to 64 the three-pass TF32 ones, and
    the rest (D % 8 != 0, D = 256, float32 D = 128) the FMA ones: the
    plan, the source's ``flash_bwd_route`` and the kernels the profiler
    sees agree."""
    from repro_torch.kernels.flash.flash import _bwd_lib

    assert flash_bwd_plan(d, dtype).kernel == route
    assert _bwd_lib().flash_bwd_route(d, FLASH_DTYPES[dtype]) == \
        BWD_ROUTES[route]
    rng = np.random.default_rng(d)
    args = _bwd_inputs(rng, card, dtype, 1, 4, 2, 150, d, True)
    names = [n for n in _kernel_names(
        lambda: flash_backward_cuda(*args, causal=True)) if "flash_bwd" in n]
    by_route = {
        "wgmma": [n for n in names if "_wgmma<" in n],
        "tf32": [n for n in names if "_tf32<" in n],
        "fma": [n for n in names
                if "flash_bwd_dkdv<" in n or "flash_bwd_dq<" in n]}
    assert any("flash_bwd_delta<" in n for n in names), names
    assert {r: len(n) for r, n in by_route.items()} == {
        r: 2 if r == route else 0 for r in by_route}, names


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_is_bitwise_repeatable(card, dtype, d):
    """No atomics: two calls give the same bits (bfloat16 on the
    tensor-core route, float32 at D 32 and 64 in three TF32 passes)."""
    rng = np.random.default_rng(11)
    args = _bwd_inputs(rng, card, dtype, 2, 8, 2, 333, d, True)
    first = flash_backward_cuda(*args, causal=True)
    second = flash_backward_cuda(*args, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_lse_equals_plain(card, dtype, d):
    """The forward's row log-sum-exp against ``flash_plain``'s, and its
    output unchanged by writing it."""
    rng = np.random.default_rng(d)
    q, k, v = _flash_qkv(rng, card, dtype, 300, 300, d, b=2, h=4)
    out, lse = flash_cuda(q, k, v, causal=True, return_lse=True)
    plain_out, plain_lse = flash_plain(q, k, v, causal=True,
                                       return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 300)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, plain_lse, rtol=tol, atol=tol)
    assert torch.equal(out, flash_cuda(q, k, v, causal=True))
    assert torch.allclose(out.float(), plain_out.float(), rtol=3e-2,
                          atol=3e-2)


@pytest.mark.cuda
def test_cuda_flash_bwd_plan_matches_the_kernel(card):
    """``flash_bwd_plan``'s route and shared memory are what the source
    launches with, in both types."""
    from repro_torch.kernels.flash.flash import _bwd_lib

    lib = _bwd_lib()
    for dtype, code in FLASH_DTYPES.items():
        for d in range(1, 257):
            plan = flash_bwd_plan(d, dtype)
            assert (lib.flash_bwd_smem_bytes(d, code, 0),
                    lib.flash_bwd_smem_bytes(d, code, 1)) == (
                        plan.dkdv_smem, plan.dq_smem), (dtype, d)
            assert lib.flash_bwd_route(d, code) == BWD_ROUTES[plan.kernel]
        assert lib.flash_bwd_smem_bytes(257, code, 0) == -1
        assert lib.flash_bwd_route(0, code) == -1
    assert lib.flash_bwd_smem_bytes(64, 2, 0) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_gradient_through_the_kernels(card, dtype):
    """``flash_attention`` under autograd: one K4 launch forward, one
    backward call, and the gradient equal to the plain backward's on the
    saved tensors."""
    rng = np.random.default_rng(3)
    q, k, v, _, _, dout = _bwd_inputs(rng, card, dtype, 1, 8, 2, 150, 64,
                                      True)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    f0, b0 = flash_cuda.launches, flash_backward_cuda.launches
    out = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (flash_cuda.launches - f0, flash_backward_cuda.launches - b0) == (
        1, 1)
    _, lse = flash_plain(q.detach(), k.detach(), v.detach(), causal=True,
                         return_lse=True)
    want = flash_plain_backward(q.detach(), k.detach(), v.detach(),
                                out.detach(), lse, dout, causal=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert _rel_max(g, w) <= tol


@pytest.mark.cuda
def test_cuda_flash_backward_rejects_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 16, 8, device=card)
    lse = torch.zeros(1, 2, 16, device=card)
    with pytest.raises(TypeError, match="float32"):
        flash_backward_cuda(q, q, q, q, lse, q.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        flash_backward_cuda(q, q, q, q, lse.double(), q)
    with pytest.raises(ValueError, match="lse"):
        flash_backward_cuda(q, q, q, q, lse[:, :, :8].contiguous(), q)
    # The tensor-core route reads by TMA: data 2 bytes past an aligned
    # start is refused before any launch.
    odd = torch.zeros(1 + q.numel(), dtype=torch.bfloat16,
                      device=card)[1:].view(q.shape)
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 2
    before = flash_backward_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_backward_cuda(odd, q.bfloat16(), q.bfloat16(), q.bfloat16(),
                            lse, q.bfloat16())
    assert flash_backward_cuda.launches == before


@pytest.mark.cuda
def test_cuda_smoke_train_step_equals_the_cpu_step(card):
    """One llama3.2-1b smoke step in float32 on the card (K4 and its
    backward kernels) against the same step on the CPU (their plain
    versions) from the same weights and tokens: loss and ``grad_norm``
    within rtol 1e-5 / 1e-4, and every weight after the step within
    2 x ``lr`` + 1e-6 (a first AdamW step moves a weight by about ``lr``
    times its gradient's sign, so a gradient ~0 on both may go either
    way)."""
    import copy
    import dataclasses

    from repro_torch.kernels.flash import flash_backward_cuda
    from repro_torch.launch import train as ltrain
    from repro_torch.train import init_train_state

    cfg, cpu_state = ltrain.build("llama3.2-1b", smoke=True, device="cpu")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    card_state = init_train_state(copy.deepcopy(cpu_state.params).to(card))
    batch = ltrain.synthetic_batch(cfg.vocab, 4, 64, 0, device="cpu")
    step = ltrain.make_step(cfg, total_steps=10)
    before = flash_backward_cuda.launches
    card_state, got = step(card_state, {k: v.to(card)
                                        for k, v in batch.items()})
    torch.cuda.synchronize()
    assert flash_backward_cuda.launches == before + cfg.n_layers
    cpu_state, want = step(cpu_state, batch)
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(),
                               want["grad_norm"].item(), rtol=1e-4)
    atol = 2 * want["lr"].item() + 1e-6
    for (name, a), b in zip(card_state.params.named_parameters(),
                            cpu_state.params.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=atol, msg=name)


# --------------------------------------------------------------------------
# the GNN side: K2a as mp_segment_sum's kernel
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 47, 64, 640])
def test_cuda_k2_autograd_function_equals_plain(card, d):
    """``SegmentSumFn`` on the card (K2a, one launch a call) against the
    float64 sum in its forward (``_segsum_tol``) and against its plain
    twin's gradient (a gather: bitwise), with ids outside ``[0, N)``;
    ``mp_segment_sum`` of ``[E, 8, d // 8 or 1]`` rows reaches it."""
    from repro_torch.kernels.segsum import SegmentSumFn
    from repro_torch.sparse.segment import mp_segment_sum

    rng = np.random.default_rng(100 + d)
    e, n = 60000, 7000
    x = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(-3, n + 3, e).astype(np.int32)
    g = rng.standard_normal((n, d)).astype(np.float32)
    a = torch.as_tensor(x, device=card).requires_grad_(True)
    b = torch.as_tensor(x).requires_grad_(True)
    ids_c = torch.as_tensor(ids, device=card)
    before = segsum_cuda.launches
    got = SegmentSumFn.apply(a, ids_c, n)
    torch.cuda.synchronize()
    assert segsum_cuda.launches == before + 1
    torch.testing.assert_close(got.double(), _segsum_f64(a.detach(), ids_c,
                                                         n),
                               **_segsum_tol(e, n, torch.float32))
    (got * torch.as_tensor(g, device=card)).sum().backward()
    (SegmentSumFn.apply(b, torch.as_tensor(ids), n)
     * torch.as_tensor(g)).sum().backward()
    assert torch.equal(a.grad.cpu(), b.grad)
    rows = (d // 8, 8) if d % 8 == 0 else (d,)
    before = segsum_cuda.launches
    out = mp_segment_sum(a.detach().reshape((e,) + rows), ids_c, n)
    torch.cuda.synchronize()
    assert segsum_cuda.launches == before + 1
    assert out.shape == (n,) + rows
    torch.testing.assert_close(out.reshape(n, d), got.detach(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_k2_autograd_function_launch_failure_raises(card, monkeypatch):
    """A K2a launch that fails raises from ``mp_segment_sum``: no plain
    twin on the card."""
    from repro_torch.sparse.segment import mp_segment_sum

    class Broken:
        def segsum_launch(self, *args):
            return 700

    monkeypatch.setattr(segsum_module, "_kernel_lib", lambda: Broken())
    x = torch.ones(10, 4, device=card)
    with pytest.raises(RuntimeError, match="segsum kernel launch failed"):
        mp_segment_sum(x, torch.zeros(10, dtype=torch.int32, device=card), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gat-cora", "pna", "nequip", "mace"])
def test_cuda_gnn_smoke_step_equals_the_cpu_step(card, arch):
    """One AdamW step of each GNN ``smoke()`` config on the card (K2a in
    every float message sum) against the same step on the CPU (K2a's
    plain version) from the same weights and graph: the loss within
    rtol 1e-5, ``grad_norm`` within rtol 1e-4, every weight after the
    step within 2 x ``lr`` + 1e-6 (a first AdamW step moves a weight by
    about ``lr`` times its gradient's sign), K2a launched."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.gnn import equivariant, gat, pna, random_graph
    from repro_torch.train import (
        AdamWConfig,
        init_train_state,
        make_train_step,
    )
    from repro_torch.train.tree import leaves

    mod = {"gat-cora": gat, "pna": pna}.get(arch, equivariant)
    cfg = get_config(arch, smoke=True).model

    def graph(dev):
        if mod is equivariant:
            g = random_graph(60, 240, with_positions=True,
                             n_species=cfg.n_species, n_graphs=4, seed=3,
                             device=dev)
            return dataclasses.replace(
                g, labels=torch.linspace(-1, 1, 4, device=dev))
        return random_graph(60, 240, d_feat=cfg.d_in,
                            n_classes=cfg.n_classes, seed=3, device=dev)

    params = mod.init_params(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b),
                           AdamWConfig(lr=1e-2, total_steps=10))
    card_state = init_train_state(_tree_to(params, card))
    cpu_state = init_train_state(params)
    before = segsum_cuda.launches
    card_state, got = step(card_state, graph(card))
    torch.cuda.synchronize()
    assert segsum_cuda.launches > before
    cpu_state, want = step(cpu_state, graph("cpu"))
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(),
                               want["grad_norm"].item(), rtol=1e-4)
    atol = 2 * want["lr"].item() + 1e-6
    for a, b in zip(leaves(card_state.params), leaves(cpu_state.params)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=atol)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.detach().to(dev)


# --------------------------------------------------------------------------
# the recsys side: K4 bidirectional in float32, embedding_bag on K2a
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 1])
def test_cuda_flash_bidirectional_float32_at_bert4rec_shape(card, b):
    """K4 at BERT4Rec's attention shape (``[B, 2, 200, 32]`` float32,
    ``causal=False``: the three-pass TF32 kernels, 200 keys in one
    ``block_k``) through ``models.attention.bidirectional_attention``:
    the forward within 2e-5 of ``flash_plain`` and
    ``naive_attention(causal=False)``, the backward kernels within 1e-4 of
    each tensor's largest magnitude of ``flash_plain_backward``; one
    forward and one backward launch, of the TF32 kernels (the profiler's
    names)."""
    from repro_torch.models.attention import (
        bidirectional_attention,
        naive_attention,
    )

    rng = np.random.default_rng(200 + b)
    q, k, v, out, lse, dout = _bwd_inputs(rng, card, torch.float32, b, 2, 2,
                                          200, 32, False)
    p_out, p_lse = flash_plain(q, k, v, causal=False, return_lse=True)
    torch.testing.assert_close(out, p_out, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=1e-5)
    # The model's route, [B, S, H, hd], with a gradient.
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    before = (flash_cuda.launches, flash_backward_cuda.launches)
    got = bidirectional_attention(qs, ks, vs)
    got.backward(dout.transpose(1, 2))
    torch.cuda.synchronize()
    assert (flash_cuda.launches, flash_backward_cuda.launches) == (
        before[0] + 1, before[1] + 1)

    def step():
        x, y, z = (t.detach().requires_grad_(True) for t in (qs, ks, vs))
        bidirectional_attention(x, y, z).backward(dout.transpose(1, 2))

    names = [n for n in _kernel_names(step) if "flash" in n]
    for kernel in ("flash_tf32_kernel<32, 32, 2>",
                   "flash_bwd_dkdv_tf32<32, 2>", "flash_bwd_dq_tf32<32, 2>"):
        assert any(kernel in n for n in names), (kernel, names)
    assert not any("flash_kernel<" in n or "flash_bwd_dkdv<" in n
                   for n in names), names
    want = naive_attention(*(t.detach() for t in (qs, ks, vs)),
                           causal=False)
    torch.testing.assert_close(got.detach(), want, rtol=2e-5, atol=2e-5)
    grads = flash_plain_backward(q, k, v, p_out, p_lse, dout, causal=False)
    for name, g, w in zip("qkv", (qs.grad, ks.grad, vs.grad), grads):
        g = g.transpose(1, 2)
        assert torch.isfinite(g).all(), name
        assert _rel_max(g, w) <= 1e-4, (name, _rel_max(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_cuda_embedding_bag_on_k2a_equals_plain(card, mode):
    """``sparse.embedding_bag`` on the card: ``sum`` and ``mean`` through
    K2a (one launch a call), ``max`` through the scatter, against the
    same call on the CPU (K2a's plain version) within 1e-4 of the
    output's largest magnitude; bags in any order, empty ones too; the
    sum's gradient against the CPU's."""
    from repro_torch.sparse import embedding_bag

    rng = np.random.default_rng(31)
    table = rng.standard_normal((5000, 64)).astype(np.float32)
    idx = rng.integers(0, 5000, 40_000)
    bags = rng.integers(0, 700, 40_000)
    bags[bags == 5] = 6                         # bag 5 stays empty
    w = rng.uniform(0.5, 2.0, 40_000).astype(np.float32)
    args = [torch.from_numpy(x) for x in (table, idx, bags, w)]
    want_t = args[0].clone().requires_grad_(True)
    want = embedding_bag(want_t, args[1], args[2], 700, mode=mode,
                         weights=args[3])
    got_t = args[0].to(card).requires_grad_(True)
    before = segsum_cuda.launches
    got = embedding_bag(got_t, args[1].to(card), args[2].to(card), 700,
                        mode=mode, weights=args[3].to(card))
    torch.cuda.synchronize()
    assert segsum_cuda.launches == before + (0 if mode == "max" else 1)
    assert got.shape == (700, 64) and bool((got[5] == 0).all())
    assert _rel_max(got.detach().cpu(), want.detach()) <= 1e-4
    cot = torch.from_numpy(rng.standard_normal((700, 64)).astype(np.float32))
    (want * cot).sum().backward()
    (got * cot.to(card)).sum().backward()
    assert _rel_max(got_t.grad.cpu(), want_t.grad) <= 1e-4


@pytest.mark.cuda
def test_cuda_bert4rec_smoke_step_equals_the_cpu_step(card):
    """One BERT4Rec smoke step (``loss_sampled``, AdamW) on the card (K4
    bidirectional: two forward and two backward launches) against the
    same step on the CPU from the same weights and batch: the loss within
    rtol 1e-5, ``grad_norm`` within 1e-4, every weight within 2 x ``lr``
    + 1e-6; then ``serve_score`` and ``retrieval_score`` against the
    CPU's within 1e-5 of their largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models.recsys import bert4rec
    from repro_torch.train import AdamWConfig, init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.tree import leaves

    cfg = get_config("bert4rec", smoke=True).model
    rng = np.random.default_rng(0)
    items = rng.integers(1, cfg.n_items, (8, cfg.max_seq))
    items[:, :3] = 0
    pos = np.stack([rng.choice(cfg.max_seq, 3, replace=False)
                    for _ in range(8)])
    labels = np.take_along_axis(items, pos, axis=1)
    np.put_along_axis(items, pos, cfg.mask_id, axis=1)
    batch = {"items": items, "masked_pos": pos, "labels": labels,
             "negatives": rng.integers(1, cfg.n_items, 64)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = bert4rec.init_params(torch.Generator().manual_seed(0), cfg)
    step = make_train_step(lambda p, b: bert4rec.loss_sampled(p, cfg, b),
                           AdamWConfig(lr=1e-3, total_steps=10))
    card_state = init_train_state(_tree_to(params, card))
    cpu_state = init_train_state(params)
    before = (flash_cuda.launches, flash_backward_cuda.launches)
    card_state, got = step(card_state, {k: v.to(card)
                                        for k, v in batch.items()})
    torch.cuda.synchronize()
    assert (flash_cuda.launches - before[0],
            flash_backward_cuda.launches - before[1]) == (2, 2)
    cpu_state, want = step(cpu_state, batch)
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].item(),
                               want["grad_norm"].item(), rtol=1e-4)
    atol = 2 * want["lr"].item() + 1e-6
    for a, b in zip(leaves(card_state.params), leaves(cpu_state.params)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                   atol=atol)
    with torch.no_grad():
        x = batch["items"][:2]
        cand = batch["negatives"]
        s_card = bert4rec.serve_score(card_state.params, cfg, x.to(card))
        s_cpu = bert4rec.serve_score(cpu_state.params, cfg, x)
        assert _rel_max(s_card.cpu(), s_cpu) <= 1e-5
        r_card = bert4rec.retrieval_score(card_state.params, cfg,
                                          x[:1].to(card), cand.to(card))
        assert _rel_max(r_card.cpu(), s_cpu[0][cand]) <= 1e-5
