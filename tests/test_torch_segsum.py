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
bitwise against ``segsum_plain``.  The card-only tests of the kernels
are in ``test_torch_cuda.py``.
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
    _tree_sizes,
    k2a_geometry,
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
