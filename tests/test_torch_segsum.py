"""Parity of the port's segment-sum wrapper with the JAX package's, on
the CPU.

The port's ``segment_sum_mxu`` runs its kernels' plain versions here
(both forms: unsorted and ``sorted_dst=True``).  It is held against the
JAX package's ``segment_sum_mxu(..., interpret=True)`` (the Pallas
kernel in interpret mode) and its ``segment_sum_ref`` oracle on the same
numpy inputs from a seed, with the tolerance of ``tests/test_kernels.py``:
the ``(E, N, D)`` sweep in float32 and bfloat16, the sorted form, ids
outside ``[0, N)``, an empty input and a non-finite message (where the
port follows the oracle and the TPU kernel does not).  K2a's launch
geometry is checked here, and its block logic (count, plan, scatter,
per-item partials, combine tree) through a plain-torch emulation held
bitwise against ``segsum_plain``; K2b's likewise (the merge-path
searches, each block's shares, rows and pieces, the segmented scan and
the carries' combine tree), held bitwise against ``segsum_sorted_plain``
on integer-valued messages and within tolerance on random ones, and
arrival-order free.  The card-only tests of the kernels are in
``test_torch_cuda.py``.
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
from repro_torch.kernels.segsum.segsum import (
    K2A_FAN_IN,
    K2A_SMEM_BYTES,
    K2B_FAN_IN,
    K2B_MIN_BLOCKS,
    K2B_SMEM_LIMIT,
    K2B_THREADS,
    _tree_sizes,
    k2a_geometry,
    k2b_geometry,
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


@pytest.mark.parametrize("bad", ["past E", "decreasing", "below 0"])
def test_segsum_sorted_checks_its_offsets(monkeypatch, bad):
    """The sorted form checks the offsets it makes in the same sync as the
    ids, before the kernel reads them: offsets past ``E``, decreasing or
    negative raise even where the ids are sorted."""
    from repro_torch.kernels.segsum import ops as ops_module

    msgs = torch.ones(6, 2)
    dst = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32)
    good = ops_module.csr_row_offsets(dst, 3)
    broken = {"past E": [0, 2, 4, 7], "decreasing": [0, 4, 2, 6],
              "below 0": [-1, 2, 4, 6]}[bad]
    monkeypatch.setattr(ops_module, "csr_row_offsets",
                        lambda d, n: torch.tensor(broken, dtype=torch.int32))
    with pytest.raises(ValueError, match="non-decreasing"):
        segment_sum_mxu(msgs, dst, 3, sorted_dst=True)
    monkeypatch.setattr(ops_module, "csr_row_offsets", lambda d, n: good)
    assert torch.equal(segment_sum_mxu(msgs, dst, 3, sorted_dst=True),
                       torch.full((3, 2), 2.0))


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


# Static shared memory of csrc/segsum.cu's k2a_accumulate beside its
# tile and bins: the touched-row masks, (1 + K2A_FAN_IN) x 128 words; a
# sorted chunk of 512 edges (int32 index, uint16 row); 8 warp sums and
# a flag.
K2A_STATIC_SMEM = (1 + K2A_FAN_IN) * 128 * 4 + 512 * 6 + 8 * 4 + 4


def _k2a_items(dst, n, block_n, block_e):
    """Work items and combine-tree (slots, tickets) each tile needs."""
    ids = np.asarray(dst, np.int64)
    ids = ids[(ids >= 0) & (ids < n)]
    counts = np.bincount(ids // block_n, minlength=-(-n // block_n))
    items = np.maximum(1, -(-counts // block_e))
    trees = np.array([_tree_sizes(int(k)) for k in items]).reshape(-1, 2)
    return counts, items, trees


@pytest.mark.parametrize("d", [1, 3, 64, 100, 1024, 20000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2a_geometry(d, dtype):
    """Shared memory within the budget, 16-byte loads only where every
    row starts on a 16-byte boundary, column slices that cover D, and
    grid and scratch bounds at or above what skewed ids need."""
    size = DTYPES[dtype][0].itemsize
    rng = np.random.default_rng(d)
    n, block_n, block_e = 700, 32, 40
    dst = np.minimum(rng.zipf(1.3, 6000) - 1, n + 3).astype(np.int32)
    dst[:900] = 5                                     # one heavy tile
    geo = k2a_geometry(dst.size, n, d, size, block_n, block_e)
    assert geo.smem_bytes == 4 * block_n * (geo.d_slice + 1)
    assert geo.smem_bytes <= K2A_SMEM_BYTES
    assert geo.smem_bytes + K2A_STATIC_SMEM <= 48 * 1024
    assert geo.vec in (1, 16 // size)
    assert (geo.vec > 1) == (d * size % 16 == 0)
    assert geo.d_slice % geo.vec == 0
    assert (geo.n_slices - 1) * geo.d_slice < d <= geo.n_slices * geo.d_slice
    assert k2a_geometry(dst.size, n, d, size, block_n, block_e,
                        aligned=False).vec == 1
    counts, items, trees = _k2a_items(dst, n, block_n, block_e)
    assert geo.n_tiles == counts.size
    assert geo.grid_items >= items.sum()
    assert geo.slots >= trees[:, 0].sum() and geo.tickets >= trees[:, 1].sum()
    # The bounds hold for the worst tiles too: every tile one item over.
    worst = np.repeat(np.arange(n // block_n) * block_n, block_e + 1)
    _, items, trees = _k2a_items(worst, n, block_n, block_e)
    geo = k2a_geometry(worst.size, n, d, size, block_n, block_e)
    assert geo.grid_items >= items.sum()
    assert geo.slots >= trees[:, 0].sum() and geo.tickets >= trees[:, 1].sum()


K2A_CHUNK, K2A_THREADS = 512, 256  # kChunk, kMaxThreads in the source


def _k2a_fold(msgs, edges, rows_of, rows, c0, cols, geo):
    """One work item's tile: its edges K2A_CHUNK at a time, sorted by row,
    cut into one run per lane group (ending on row boundaries unless a
    row is longer than a run), each run folded row by row and each row's
    sum added into the tile (``k2a_accumulate``'s main loop)."""
    nv = -(-geo.d_slice // geo.vec)
    lanes = min(32, 1 << (nv - 1).bit_length())
    groups = K2A_THREADS // lanes
    tile = torch.zeros(rows, cols)
    for at in range(0, edges.numel(), K2A_CHUNK):
        order = torch.argsort(rows_of[at:at + K2A_CHUNK], stable=True)
        e_s = edges[at:at + K2A_CHUNK][order]
        r_s = rows_of[at:at + K2A_CHUNK][order]
        size = e_s.numel()
        per = -(-size // groups)
        first = torch.searchsorted(r_s, r_s, right=False)
        last = torch.searchsorted(r_s, r_s, right=True)

        def snap(p):  # a run's start, moved on past a short row
            if p >= size:
                return size
            if first[p] == p or last[p] - first[p] > per:
                return p
            return int(last[p])

        for g in range(groups):
            a, b = snap(g * per), snap((g + 1) * per)
            assert a <= b
            run_rows, run_edges = r_s[a:b], e_s[a:b]
            for r in torch.unique_consecutive(run_rows).tolist():
                x = msgs[run_edges[run_rows == r], c0:c0 + cols].float()
                tile[r] += x.sum(0)
    return tile


def _k2a_emulate(msgs, dst, n, block_n, block_e):
    """K2a's block logic in plain torch, as ``csrc/segsum.cu`` runs it:
    count -> plan -> scatter -> one float32 tile per (work item, column
    slice), folded by ``_k2a_fold`` -> partials of heavy tiles met in the
    combine tree (the last of a group to arrive sums the group in item
    order) -> the root stores, rounded once.  Blocks run here in item
    order; every index the kernel would use is checked against the
    geometry's bounds."""
    e, d = msgs.shape
    geo = k2a_geometry(e, n, d, msgs.element_size(), block_n, block_e)
    ids = dst.long()
    keep = (ids >= 0) & (ids < n)
    tile_of = torch.where(keep, ids // block_n, torch.full_like(ids, -1))
    counts = torch.bincount(tile_of[keep], minlength=geo.n_tiles)    # 1
    items = torch.clamp(-(-counts // block_e), min=1)               # 2
    trees = torch.tensor([_tree_sizes(int(k)) for k in items],
                         dtype=torch.long).reshape(-1, 2)
    off = [torch.cat([torch.zeros(1, dtype=torch.long), x.cumsum(0)])
           for x in (counts, items, trees[:, 0], trees[:, 1])]
    edge_off, item_off, slot_off, ticket_off = off
    assert int(item_off[-1]) <= geo.grid_items
    assert int(slot_off[-1]) <= geo.slots
    assert int(ticket_off[-1]) <= geo.tickets
    kept = torch.nonzero(keep).flatten()                              # 3
    bucket = kept[torch.argsort(tile_of[kept], stable=True)]
    bucket_row = ids[bucket] - tile_of[bucket] * block_n
    assert bool((bucket_row < block_n).all())
    out = torch.empty(n, d, dtype=msgs.dtype)
    partial, mask, tickets = {}, {}, {}
    for item in range(int(item_off[-1])):                             # 4
        t = int(torch.searchsorted(item_off, item, right=True)) - 1
        k, j = int(items[t]), item - int(item_off[t])
        e0 = int(edge_off[t]) + j * block_e
        e1 = min(e0 + block_e, int(edge_off[t + 1]))
        r0 = t * block_n
        rows = min(block_n, n - r0)
        for s in range(geo.n_slices):
            c0 = s * geo.d_slice
            cols = min(geo.d_slice, d - c0)
            acc = _k2a_fold(msgs, bucket[e0:e1], bucket_row[e0:e1], rows,
                            c0, cols, geo)
            touched = torch.zeros(rows, dtype=torch.bool)
            touched[bucket_row[e0:e1]] = True
            node, level = j, k
            slot, ticket = int(slot_off[t]), int(ticket_off[t])
            arrived = True
            while level > 1:
                group = node // K2A_FAN_IN
                first = group * K2A_FAN_IN
                size = min(K2A_FAN_IN, level - first)
                if size > 1:
                    assert slot + node < int(slot_off[t + 1])
                    partial[slot + node, s] = torch.where(
                        touched[:, None], acc, torch.nan)
                    mask[slot + node, s] = touched.clone()
                    assert ticket + group < int(ticket_off[t + 1])
                    tickets[ticket + group, s] = tickets.get(
                        (ticket + group, s), 0) + 1
                    if tickets[ticket + group, s] != size:
                        arrived = False
                        break
                    acc = torch.zeros(rows, cols)
                    touched = torch.zeros(rows, dtype=torch.bool)
                    for m in range(first, first + size):
                        got = mask[slot + m, s]
                        acc = torch.where(got[:, None],
                                          acc + partial[slot + m, s], acc)
                        touched |= got
                slot += level
                level = -(-level // K2A_FAN_IN)
                ticket += level
                node = group
            if arrived:
                out[r0:r0 + rows, c0:c0 + cols] = acc.to(msgs.dtype)
    return out


K2A_CASES = {
    # name: (E, N, D, block_n, block_e, ids)
    "one segment": (700, 50, 6, 16, 8, lambda rng, e, n: np.zeros(e)),
    "all ids dropped": (300, 40, 5, 16, 8,
                        lambda rng, e, n: rng.choice([-1, n, n + 9], e)),
    "N not a multiple of block_n": (
        900, 53, 4, 16, 8, lambda rng, e, n: rng.integers(-2, n + 2, e)),
    "tiles of block_e and block_e + 1 edges": (
        2 * 8 + 2 * 9, 64, 3, 16, 8,
        lambda rng, e, n: np.repeat([0, 17, 33, 63], [8, 8, 9, 9])),
    "column slices, heavy tiles": (
        500, 4100, 12, 2048, 30,
        lambda rng, e, n: rng.choice([0, 1, 2047, 2048, 4099], e)),
    "items of several sorted chunks": (
        2500, 20, 5, 16, 1100, lambda rng, e, n: rng.integers(0, n, e)),
    "E = 0": (0, 30, 4, 16, 8, lambda rng, e, n: np.zeros(0)),
}


@pytest.mark.parametrize("case", list(K2A_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2a_block_logic_emulation_equals_plain(case, dtype):
    """The emulation of K2a's kernels equals ``segsum_plain`` bitwise on
    integer-valued messages (every order of adds gives the same bits)."""
    e, n, d, block_n, block_e, make_ids = K2A_CASES[case]
    rng = np.random.default_rng(e + n)
    ids = torch.as_tensor(np.asarray(make_ids(rng, e, n), np.int32))
    msgs = torch.as_tensor(rng.integers(-8, 9, (e, d)).astype(np.float32))
    msgs = msgs.to(DTYPES[dtype][0])
    got = _k2a_emulate(msgs, ids, n, block_n, block_e)
    want = segsum_plain(msgs, ids, n)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("d", [1, 3, 4, 7, 8, 64, 100, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2b_geometry(d, dtype):
    """Narrow rows (at most 4 bytes) staged with one lane a share, wider
    ones in 16-byte vectors only where every row is aligned, lane groups
    that cover a row's vectors, a grid that covers every item, a ticket
    level per factor of the fan-in, and shared memory within the budget."""
    size = DTYPES[dtype][0].itemsize
    e, n, block_e = 2_838_951, 782_659, 512
    geo = k2b_geometry(e, n, d, size, block_e)
    row = d * size
    assert geo.narrow == (row <= 4)
    if geo.narrow:
        assert geo.vec == d and geo.lanes == 1
    else:
        assert geo.vec == (16 // size if row % 16 == 0 else 1)
        nv = d // geo.vec
        assert geo.lanes in (1, 2, 4, 8, 16, 32)
        assert geo.lanes >= min(nv, 32) and (geo.lanes == 1
                                             or geo.lanes // 2 < nv)
        assert k2b_geometry(e, n, d, size, block_e, aligned=False).vec == 1
    assert geo.items == block_e * max(1, min(16, (64 if geo.narrow
                                                   else 1024) // row))
    assert (geo.blocks - 1) * geo.items < n + e <= geo.blocks * geo.items
    assert K2B_FAN_IN ** geo.levels >= geo.blocks
    assert K2B_FAN_IN ** (geo.levels - 1) < geo.blocks
    if geo.narrow:   # r + 1 offsets, then the other items' rows and a
        # short row read again
        assert geo.smem_bytes >= max(
            4 * ((r + 4) // 4 * 4) + (geo.items - r + geo.items // 8) * row
            for r in range(geo.items + 1))
    else:
        assert geo.smem_bytes == 4 * ((geo.items + 4) // 4 * 4)
    assert geo.smem_bytes <= K2B_SMEM_LIMIT
    assert geo.carry_floats == 2 * geo.blocks * d
    one = k2b_geometry(10, 3, d, size, block_e)
    assert one.blocks == 1 and one.levels == 0 and one.items == block_e
    small = k2b_geometry(200_000, 3_000, d, size, block_e)
    assert small.items == block_e or small.blocks >= K2B_MIN_BLOCKS
    with pytest.raises(ValueError, match="shared memory"):
        k2b_geometry(e, n, d, size, 1 << 16)
    with pytest.raises(ValueError, match="positive"):
        k2b_geometry(e, n, d, size, 0)


K2B_PROBES = 32  # a warp's ballot a round, as in the source


def _k2b_search(off, n, k, rounds=None):
    """``diag_search``: rows that end among the merge path's first ``k``
    items, ``K2B_PROBES`` probes a round, exactly as the kernel."""
    off0, lo, hi = off[0], 0, min(k, n)
    while lo < hi:
        length = hi - lo
        fine = length <= K2B_PROBES
        probes = [lo + q if fine else lo + (q + 1) * length // (K2B_PROBES + 1)
                  for q in range(K2B_PROBES)]
        ends = [(not fine or q < length) and off[p + 1] <= off0 + k - p - 1
                for q, p in enumerate(probes)]
        cnt = sum(ends)
        assert ends == [True] * cnt + [False] * (K2B_PROBES - cnt)
        if rounds is not None:
            rounds.append(length)
        next_lo = probes[cnt - 1] + 1 if cnt else lo
        hi = next_lo if fine else probes[cnt] if cnt < K2B_PROBES else hi
        lo = next_lo
    return lo


def _k2b_bisect(off, lo, hi, k):
    """``diag_search_smem``: the same count by bisection over [lo, hi]."""
    while lo < hi:
        mid = (lo + hi) // 2
        if off[mid + 1] <= off[0] + k - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo


def test_k2b_search_rounds():
    """The warp search settles DBLP's 782,659 rows in 4 dependent rounds
    and agrees with bisection and with the merge path walked item by
    item."""
    rng = np.random.default_rng(0)
    n = 782_659
    off = np.concatenate([[0], np.cumsum(rng.zipf(1.8, n) % 300)]).tolist()
    total = n + off[-1]
    for k in [0, 1, total // 3, total // 2, total - 1, total]:
        rounds = []
        assert _k2b_search(off, n, k, rounds) == _k2b_bisect(
            off, 0, min(k, n), k)
        assert len(rounds) <= 4
    small = [2, 2, 5, 5, 5, 9]           # offsets[0] > 0, empty rows
    n = len(small) - 1
    ends, i, j = [0], 0, small[0]
    for _ in range(n + small[-1] - small[0]):   # walk the path
        if i < n and small[i + 1] <= j:
            i += 1
        else:
            j += 1
        ends.append(i)
    for k, want in enumerate(ends):
        assert _k2b_search(small, n, k) == want


def _k2b_emulate(msgs, off, n, block_e, order=None):
    """K2b's block logic in plain torch, as ``csrc/segsum.cu`` runs it:
    per block the two warp searches, where it starts (earlier, at the
    first item of a short row it reads whole), its shares (one per lane
    group),
    each share's walk (rows stored, head kept, tail left open), the
    segmented scan of the tails in the kernel's order (shuffle steps in a
    warp, then earlier warps' totals ascending), heads and the block's
    pieces, then each piece through the combine tree with tickets.
    Blocks run in ``order`` (ascending by default); every row must be
    stored exactly once, and every ticket reset by its last arrival."""
    e, d = msgs.shape
    geo = k2b_geometry(e, n, d, msgs.element_size(), block_e)
    items, lanes = geo.items, geo.lanes
    groups = K2B_THREADS // lanes
    per_warp = 32 // lanes
    x = msgs.float().numpy()
    zero = np.zeros(d, np.float32)
    off = [int(v) for v in off]
    off0, total = off[0], n + off[n] - off[0]
    out = np.zeros((n, d), np.float32)
    stored = [0] * n
    carry, tickets = {}, {}

    def store(r, v):
        stored[r] += 1
        out[r] = v

    def combine(row, b_s, b_e, b):
        cb, level = b, 0
        while True:
            sh = 4 * level
            grp = (cb >> sh) >> 4
            n_lo, n_hi = max(b_s >> sh, grp << 4), min(b_e >> sh,
                                                      (grp << 4) + 15)
            if n_hi == n_lo:
                level += 1
                continue
            rep_lo = max(b_s, n_lo << sh)
            assert level < geo.levels and rep_lo < geo.blocks
            key = (level, rep_lo)
            owner, count = tickets.get(key, (row, 0))
            assert owner == row                      # one ticket, one row
            tickets[key] = (row, count + 1)
            if count != n_hi - n_lo:
                return
            del tickets[key]                  # the last arrival resets it
            acc = zero
            for m in range(n_lo, n_hi + 1):
                rep = max(b_s, m << sh)
                acc = acc + carry[2 * b_e if rep == b_e else 2 * rep + 1]
            if (b_s >> (sh + 4)) == (b_e >> (sh + 4)):
                store(row, acc)
                return
            carry[2 * rep_lo + 1] = acc
            cb, level = rep_lo, level + 1

    reread = items // 8
    for b in order if order is not None else range(geo.blocks):
        k0 = b * items
        if k0 >= total:
            continue
        k1 = min(k0 + items, total)
        i0, i1 = _k2b_search(off, n, k0), _k2b_search(off, n, k0 + items)
        j0, j1 = off0 + k0 - i0, off0 + k1 - i1
        # A row from the previous block with at most `reread` edges there
        # is read whole here; the previous block keeps no piece of it.
        head_in = i0 < i1 and off[i0] < j0
        whole = (head_in and (off[i0] - off0 + i0) // items == b - 1
                 and j0 - off[i0] <= reread)
        ks = off[i0] - off0 + i0 if whole else k0
        block_head = head_in and not whole
        block_tail = i1 < n and off[i1] < j1 and not (
            (off[i1] - off0 + i1) // items == b
            and (off[i1 + 1] - off0 + i1) // items == b + 1
            and off0 + (b + 1) * items - i1 - off[i1] <= reread)
        per = -(-(k1 - ks) // groups)
        shares = []
        for g in range(groups):
            ka = ks + min(g * per, k1 - ks)
            kb = ks + min((g + 1) * per, k1 - ks)
            if ka == k1:                       # an empty share at the end
                shares.append((i1, i1, False, zero, zero))
                continue
            ia = _k2b_bisect(off, i0, i1, ka)
            ib = _k2b_bisect(off, ia, i1, kb)
            ea, eb = off0 + ka - ia, off0 + kb - ib
            split = ia < ib and off[ia] < ea
            acc, head, r = zero, zero, ia
            for edge in range(ea, eb + 1):
                while r < ib and (edge == eb or off[r + 1] <= edge):
                    if r == ia and split:
                        head = acc
                    else:
                        store(r, acc)
                    acc, r = zero, r + 1
                if edge < eb:
                    acc = acc + x[edge]
            shares.append((ia, ib, split, head, acc))
        # The scan, all groups at once (elementwise float32, as lanes).
        keys = np.array([sh[1] for sh in shares])
        scan = np.stack([sh[4] for sh in shares])
        lane = np.arange(groups) % per_warp
        o = 1
        while o < per_warp:                      # shuffles, in a warp
            up = np.roll(scan, o, axis=0)
            hit = (lane >= o) & (np.roll(keys, o) == keys)
            scan = np.where(hit[:, None], up + scan, scan)
            o *= 2
        last = np.arange(8) * per_warp + per_warp - 1
        within = scan[last]
        pre, have = np.zeros_like(scan), np.zeros(groups, bool)
        warp_of = np.arange(groups) // per_warp
        for w in range(8):                       # earlier warps' totals
            hit = (warp_of > w) & (keys == keys[last[w]])
            pre = np.where((hit & have)[:, None], pre + within[w],
                           np.where(hit[:, None], within[w], pre))
            have |= hit
        scan = np.where(have[:, None], pre + scan, scan)
        for g, (ia, ib, split, head, _) in enumerate(shares):
            if not split:
                continue
            h = scan[g - 1] + head if g > 0 else head
            if ia == i0 and block_head:
                carry[2 * b] = h
            else:
                store(ia, h)
        if block_tail:
            carry[2 * b + 1] = scan[-1]
        if block_head:
            combine(i0, (off[i0] - off0 + i0) // items, b, b)
        if block_tail:
            combine(i1, (off[i1] - off0 + i1) // items,
                    (off[i1 + 1] - off0 + i1) // items, b)
    assert stored == [1] * n
    assert not tickets                        # all back to 0
    return torch.from_numpy(out).to(msgs.dtype)


def _row_lengths(case, rng):
    """Row lengths of a K2b case: (lengths, edges before row 0, after the
    last row)."""
    if case == "short rows, some empty":
        return rng.integers(0, 6, 300), 0, 0
    if case == "one row takes every edge":
        return np.array([1500, 0, 0]), 0, 0
    if case == "a long row across many blocks, empty rows around it":
        return np.concatenate([rng.integers(0, 3, 40), [2600], np.zeros(
            30, int), rng.integers(0, 4, 50)]), 0, 0
    if case == "edges dropped before and after":
        return rng.integers(0, 9, 200), 37, 11
    if case == "skewed rows":
        return np.minimum(rng.zipf(1.5, 80), 300), 0, 0
    raise KeyError(case)


K2B_CASES = [(case, d) for case in (
    "short rows, some empty", "one row takes every edge",
    "edges dropped before and after", "skewed rows")
    for d in (1, 3, 7, 8, 64)] + [
    ("a long row across many blocks, empty rows around it", d)
    for d in (1, 3, 7, 8, 64, 1000)]


@pytest.mark.parametrize("case,d", K2B_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2b_block_logic_emulation_equals_plain(case, d, dtype):
    """The emulation of K2b's kernel equals ``segsum_sorted_plain``
    bitwise on integer-valued messages (every order of adds gives the
    same bits) and within tolerance on random ones, and gives the same
    bits when its blocks arrive in another order.  ``block_e`` is small,
    so rows are cut across shares and blocks (the long row across more
    than 16 blocks climbs two levels of the tree) and E is no multiple
    of it."""
    rng = np.random.default_rng(d + len(case))
    lengths, before, after = _row_lengths(case, rng)
    n = lengths.size
    off = before + np.concatenate([[0], np.cumsum(lengths)])
    e = int(off[-1]) + after
    size = DTYPES[dtype][0].itemsize
    block_e = max(2, 48 // k2b_geometry(e, n, d, size, 1).items)
    assert k2b_geometry(e, n, d, size, block_e).blocks > 2 * K2B_FAN_IN \
        or case != "a long row across many blocks, empty rows around it"
    offsets = torch.as_tensor(off.astype(np.int32))
    ints = torch.as_tensor(rng.integers(-8, 9, (e, d)).astype(np.float32))
    ints = ints.to(DTYPES[dtype][0])
    want = segsum_sorted_plain(ints, offsets, n)
    got = _k2b_emulate(ints, offsets, n, block_e)
    assert got.dtype == want.dtype and torch.equal(got, want)
    floats = torch.as_tensor(rng.standard_normal((e, d)).astype(np.float32))
    floats = floats.to(DTYPES[dtype][0])
    got = _k2b_emulate(floats, offsets, n, block_e)
    np.testing.assert_allclose(
        got.float().numpy(),
        segsum_sorted_plain(floats, offsets, n).float().numpy(),
        **_tol(e, n, dtype))
    blocks = k2b_geometry(e, n, d, size, block_e).blocks
    shuffled = _k2b_emulate(floats, offsets, n, block_e,
                            order=rng.permutation(blocks).tolist())
    assert torch.equal(got, shuffled)
