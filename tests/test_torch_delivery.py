"""Parity of the port's fused delivery with the JAX package.

* **Layouts**: ``repro_torch`` builds the same degree-class layout as
  ``repro.kernels.deliver.layout``, array for array (int32) with equal
  static fields, on random incidences (hypothesis), with forced pads,
  and on the pathological histograms of ``tests/test_delivery.py``
  (mega-hub, uniform, empty, all dead, forced all-overflow plan,
  zero-degree destinations); the planners agree on random histograms.
* **K1 plain version**: ``deliver_fused_plain`` on a carried-over JAX
  layout equals ``deliver_fused_pallas(..., interpret=True)`` per class —
  bitwise on exact payloads, ``rtol = atol = 1e-5`` on float sums.
* **K1 launch plan**: the leaf kernel's plan (slot -> destination map,
  zero-degree destinations, spans, launch order) applied to the plain
  class partials equals the JAX ``deliver_fused_classes(...,
  interpret=True)``, every destination written once; on padded layouts
  too.
* **Delivery lowerings**: the port's ``fused_deliver`` (``ell``,
  ``plain``, and ``cuda``, which takes the plain version for CPU
  tensors) equals the JAX reference ``deliver``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.api import Program as JProgram
from repro.core.engine import deliver as j_deliver
from repro.kernels.deliver import build_delivery_layout as j_build
from repro.kernels.deliver import classify_degrees as j_classify
from repro.kernels.deliver import plan_degree_classes as j_plan_classes
from repro.kernels.deliver import plan_ell_width as j_plan_ell
from repro.kernels.deliver import tile_block_bounds as j_tile_bounds
from repro.kernels.deliver.fused import deliver_fused_classes as j_classes
from repro.kernels.deliver.fused import deliver_fused_pallas
from repro.kernels.deliver.layout import ClassPlan as JClassPlan
from repro_torch.core.api import Program
from repro_torch.kernels.deliver import (
    ClassPlan,
    build_delivery_layout,
    class_span,
    classify_degrees,
    deliver_fused_cuda,
    deliver_fused_plain,
    deliver_leaf_plain,
    fused_deliver,
    layout_from_numpy,
    layout_pair,
    leaf_plan,
    plan_degree_classes,
    plan_ell_width,
    tile_block_bounds,
)
from repro_torch.sparse.segment import MONOIDS

settings.register_profile("torch_ci", max_examples=12, deadline=None)
settings.load_profile("torch_ci")

MONOID_NAMES = ("sum", "min", "max", "or", "prod")
_ARRAYS = ("class_ell", "class_src", "class_dst", "class_bounds")
_STATIC = ("n_src", "n_dst", "nnz", "rem_nnz", "class_widths", "class_rows",
           "block_n", "class_block_e", "class_max_blocks")


def _payload(rng, monoid, dtype, shape):
    """Exact payloads: every fold order gives the same bits."""
    if monoid == "or":
        return rng.random(shape) > 0.5
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
    if monoid == "prod":
        return rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape)
    x = rng.integers(-4, 5, shape).astype(np.float32)
    if monoid in ("min", "max"):
        x[rng.random(shape) < 0.05] = np.nan
    return x


@st.composite
def incidence_case(draw):
    """A random incidence list + messages (``tests/test_delivery.py``'s
    input space, with full-range int32 and NaN-bearing payloads)."""
    n_src = draw(st.integers(1, 60))
    n_dst = draw(st.integers(1, 50))
    nnz = draw(st.integers(0, 220))
    seed = draw(st.integers(0, 100_000))
    monoid = draw(st.sampled_from(MONOID_NAMES))
    dtype = draw(st.sampled_from(["float32", "int32"]))
    width = draw(st.sampled_from([(), (3,), (2, 2)]))
    with_mask = draw(st.booleans())
    with_active = draw(st.booleans())
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = rng.integers(0, n_dst, nnz).astype(np.int32)
    mask = (rng.random(nnz) > 0.25).astype(np.float32) if with_mask else None
    msg = _payload(rng, monoid, dtype, (n_src,) + width)
    active = rng.random(n_src) > 0.3 if with_active else None
    return (src, dst, mask, n_src, n_dst, monoid, msg, active)


def assert_layout_equal(t, j):
    for name in _STATIC:
        assert getattr(t, name) == getattr(j, name), name
    for name in _ARRAYS:
        tj, jj = getattr(t, name), getattr(j, name)
        assert len(tj) == len(jj), name
        for a, b in zip(tj, jj):
            assert a.dtype == torch.int32, name
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    for name in ("inv_perm", "rem_src", "rem_dst"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == torch.int32, name
        assert np.array_equal(a.numpy(), np.asarray(b)), name


def _both_layouts(src, dst, mask, n_src, n_dst, **kw):
    t = build_delivery_layout(src, dst, mask, n_src, n_dst, block_n=8,
                              block_e=16, device="cpu", **kw)
    jkw = dict(kw)
    if "plan" in jkw:
        p = jkw["plan"]
        jkw["plan"] = JClassPlan(p.widths, p.rows, p.residual)
    j = j_build(src, dst, mask, n_src, n_dst, block_n=8, block_e=16, **jkw)
    return t, j


def _reference(msg, active, src, dst, n_dst, monoid, mask):
    prog = JProgram(procedure=lambda *a: None, combiner=monoid)
    return np.asarray(j_deliver(
        jnp.asarray(msg), jnp.asarray(active) if active is not None else None,
        jnp.asarray(src), jnp.asarray(dst), n_dst, prog,
        e_mask=jnp.asarray(mask) if mask is not None else None,
    ))


def _port(msg, active, layout, monoid, lowering):
    prog = Program(procedure=None, combiner=monoid)
    act = torch.as_tensor(active) if active is not None else None
    return fused_deliver(torch.as_tensor(msg), act, layout, prog,
                         lowering=lowering).numpy()


def _assert_bitwise(got, want, tag):
    assert got.shape == want.shape and got.dtype == want.dtype, tag
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), tag


# --------------------------------------------------------------------------
# layouts and planners
# --------------------------------------------------------------------------

@given(incidence_case())
def test_layout_equals_reference(case):
    src, dst, mask, n_src, n_dst, *_ = case
    t, j = _both_layouts(src, dst, mask, n_src, n_dst)
    assert_layout_equal(t, j)


@given(incidence_case())
def test_padded_layout_equals_reference(case):
    """Forced plan and larger per-class row / lane / residual pads (the
    shard-harmonization inputs) build identical layouts too."""
    src, dst, mask, n_src, n_dst, *_ = case
    base, _ = _both_layouts(src, dst, mask, n_src, n_dst)
    t, j = _both_layouts(
        src, dst, mask, n_src, n_dst,
        plan=ClassPlan(base.class_widths, base.class_rows, base.rem_nnz),
        class_rows_pad=tuple(r + 24 for r in base.class_rows),
        class_nnz_pad=tuple(int(a.shape[0]) + 37 for a in base.class_src),
        rem_pad_to=base.rem_len + 19,
    )
    assert_layout_equal(t, j)


@st.composite
def degree_case(draw):
    n = draw(st.integers(0, 200))
    seed = draw(st.integers(0, 100_000))
    profile = draw(st.sampled_from(["uniform", "zipfish", "hub", "zero"]))
    rng = np.random.default_rng(seed)
    if profile == "uniform":
        deg = rng.integers(0, 9, n)
    elif profile == "zipfish":
        deg = (rng.pareto(1.2, n) * 3).astype(np.int64)
    elif profile == "hub":
        deg = rng.integers(0, 4, n)
        if n:
            deg[rng.integers(0, n)] = draw(st.integers(100, 200_000))
    else:
        deg = np.zeros(n, np.int64)
    return deg.astype(np.int64)


@given(degree_case())
def test_planners_equal_reference(deg):
    nnz = int(deg.sum())
    assert plan_ell_width(deg, nnz) == j_plan_ell(deg, nnz)
    tp, jp = plan_degree_classes(deg, nnz), j_plan_classes(deg, nnz)
    assert (tp.widths, tp.rows, tp.residual) == (jp.widths, jp.rows,
                                                 jp.residual)
    assert (tp.built_work, tp.weighted_work) == (jp.built_work,
                                                 jp.weighted_work)
    assert np.array_equal(classify_degrees(deg, tp.widths),
                          j_classify(deg, jp.widths))
    offsets = np.concatenate([[0], np.cumsum(deg)])
    n_pad = -(-max(len(deg), 1) // 8) * 8
    tb, tm = tile_block_bounds(offsets, n_pad, 8, 16)
    jb, jm = j_tile_bounds(offsets, n_pad, 8, 16)
    assert tm == jm and tb.dtype == np.int32 and np.array_equal(tb, jb)


def _mega_hub():
    rng = np.random.default_rng(0)
    n_src, n_dst, nnz = 64, 50, 3000
    dst = np.where(rng.random(nnz) < 0.95, 7,
                   rng.integers(0, n_dst, nnz)).astype(np.int32)
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    return src, dst, None, n_src, n_dst, {}


def _uniform():
    rng = np.random.default_rng(1)
    dst = np.repeat(np.arange(100), 8).astype(np.int32)
    src = rng.integers(0, 100, 800).astype(np.int32)
    return src, dst, None, 100, 100, {}


def _no_incidences():
    z = np.zeros(0, np.int32)
    return z, z, None, 5, 4, {}


def _all_dead():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 6, 20).astype(np.int32)
    dst = rng.integers(0, 5, 20).astype(np.int32)
    return src, dst, np.zeros(20, np.float32), 6, 5, {}


def _all_overflow():
    rng = np.random.default_rng(3)
    n_src, n_dst, nnz = 40, 30, 900
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = rng.integers(0, n_dst, nnz).astype(np.int32)
    plan = ClassPlan(widths=(1,), rows=(n_dst,), residual=nnz - n_dst)
    return src, dst, None, n_src, n_dst, {"plan": plan}


def _zero_degree():
    src = np.array([0, 1, 2, 3], np.int32)
    dst = np.array([2, 2, 2, 2], np.int32)
    return src, dst, None, 4, 9, {}


PATHOLOGICAL = {
    "mega_hub": _mega_hub,
    "uniform": _uniform,
    "no_incidences": _no_incidences,
    "all_dead": _all_dead,
    "all_overflow": _all_overflow,
    "zero_degree": _zero_degree,
}


@pytest.mark.parametrize("case", sorted(PATHOLOGICAL))
def test_pathological_layouts_and_delivery(case):
    src, dst, mask, n_src, n_dst, kw = PATHOLOGICAL[case]()
    t, j = _both_layouts(src, dst, mask, n_src, n_dst, **kw)
    assert_layout_equal(t, j)
    rng = np.random.default_rng(7)
    for monoid in MONOID_NAMES:
        msg = _payload(rng, monoid, "float32", (n_src, 2))
        active = rng.random(n_src) > 0.3
        want = _reference(msg, active, src, dst, n_dst, monoid, mask)
        for lowering in ("ell", "plain", "cuda"):
            got = _port(msg, active, t, monoid, lowering)
            _assert_bitwise(got, want, (case, monoid, lowering))
    if case == "mega_hub":
        assert t.rem_nnz == 0 and len(t.class_widths) >= 2
    if case == "all_overflow":
        assert t.rem_nnz > 0.9 * len(src)


def test_zero_destinations_and_layout_pair():
    lay = build_delivery_layout(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                None, 3, 0, block_n=8, block_e=16)
    out = fused_deliver(torch.ones(3, 2), None, lay,
                        Program(procedure=None, combiner="sum"))
    assert out.shape == (0, 2)
    rng = np.random.default_rng(2)
    src = torch.as_tensor(rng.integers(0, 50, 300).astype(np.int32))
    dst = torch.as_tensor(rng.integers(0, 30, 300).astype(np.int32))
    fwd, bwd = layout_pair(src, dst, None, 50, 30)
    assert (fwd.n_src, fwd.n_dst) == (50, 30)
    assert (bwd.n_src, bwd.n_dst) == (30, 50)
    assert fwd.nnz == bwd.nnz == 300
    assert fwd.device == torch.device("cpu")


# --------------------------------------------------------------------------
# K1: the kernel's plain version vs the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

def _k1_inputs(case, pad=False):
    src, dst, mask, n_src, n_dst, monoid, msg, active = case
    j = j_build(src, dst, mask, n_src, n_dst, block_n=8, block_e=16)
    if pad:
        j = j_build(src, dst, mask, n_src, n_dst, block_n=8, block_e=16,
                    class_rows_pad=tuple(2 * r for r in j.class_rows))
    kmonoid = "max" if monoid == "or" else monoid
    x = msg.reshape(n_src, -1)
    if monoid == "or":
        x = x.astype(np.int32)
    ident = np.asarray(MONOIDS[kmonoid].identity(
        torch.as_tensor(x).dtype), dtype=x.dtype)
    msgs_aug = np.concatenate([x, np.full((1, x.shape[1]), ident, x.dtype)])
    act_aug = None
    if active is not None:
        act_aug = np.concatenate([active.astype(np.int32), [1]]).astype(
            np.int32)
    return j, kmonoid, msgs_aug, act_aug


def _k1_compare(case, exact):
    j, kmonoid, msgs_aug, act_aug = _k1_inputs(case)
    t = layout_from_numpy(j)
    assert_layout_equal(t, j)
    for c in range(t.n_classes):
        src_c = np.asarray(j.class_src[c])
        live = (act_aug[src_c] if act_aug is not None
                else np.ones_like(src_c))
        want = np.asarray(deliver_fused_pallas(
            jnp.asarray(msgs_aug), j.class_src[c], j.class_dst[c],
            jnp.asarray(live), j.class_bounds[c], j.class_rows[c], kmonoid,
            j.class_max_blocks[c], block_n=j.block_n,
            block_e=j.class_block_e[c], interpret=True,
        ))
        got = deliver_fused_plain(
            torch.as_tensor(msgs_aug),
            torch.as_tensor(act_aug) if act_aug is not None else None,
            t.class_src[c], t.class_dst[c], t.class_bounds[c],
            t.class_rows[c], kmonoid, block_n=t.block_n,
            block_e=t.class_block_e[c],
        ).numpy()
        if exact:
            _assert_bitwise(got, want, (kmonoid, c))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@given(incidence_case())
@settings(max_examples=8)
def test_k1_plain_equals_pallas_interpret(case):
    _k1_compare(case, exact=True)


def test_k1_plain_float_sum_within_tolerance():
    rng = np.random.default_rng(7)
    n_src, n_dst, nnz = 200, 90, 4000
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = rng.integers(0, n_dst, nnz).astype(np.int32)
    msg = rng.standard_normal((n_src, 4)).astype(np.float32)
    active = rng.random(n_src) > 0.3
    _k1_compare((src, dst, None, n_src, n_dst, "sum", msg, active),
                exact=False)


def _k1_leaf_compare(case, pad=False):
    j, kmonoid, msgs_aug, act_aug = _k1_inputs(case, pad)
    t = layout_from_numpy(j)
    plan = leaf_plan(t)
    want = np.asarray(j_classes(
        jnp.asarray(msgs_aug),
        jnp.asarray(act_aug) if act_aug is not None else None, j, kmonoid,
        interpret=True,
    ))
    m = torch.as_tensor(msgs_aug)
    a = torch.as_tensor(act_aug) if act_aug is not None else None
    # The plan's assembly, as the kernel does it, on the plain partials.
    out = torch.empty((t.n_dst, m.shape[1]), dtype=m.dtype)
    written = torch.zeros(t.n_dst, dtype=torch.int64)
    for c in range(t.n_classes):
        part = deliver_fused_plain(
            m, a, t.class_src[c], t.class_dst[c], t.class_bounds[c],
            t.class_rows[c], kmonoid, block_n=t.block_n,
            block_e=t.class_block_e[c])
        slots = plan.slot_dst[plan.slot_base[c]:
                              plan.slot_base[c] + t.class_rows[c]].long()
        out[slots[slots >= 0]] = part[slots >= 0]
        written[slots[slots >= 0]] += 1
    out[plan.zero_dst.long()] = MONOIDS[kmonoid].identity(m.dtype)
    written[plan.zero_dst.long()] += 1
    assert bool((written == 1).all())
    _assert_bitwise(out.numpy(), want, kmonoid)
    leaf = deliver_leaf_plain(m[:-1], a[:-1] if a is not None else None, t,
                              kmonoid)
    _assert_bitwise(leaf.numpy(), want, kmonoid)
    # The kernel's side of the plan: spans that tile the classes, the
    # widest class launched first.
    for c in range(t.n_classes):
        span = plan.spans[c]
        assert t.block_n % span == 0 or span % t.block_n == 0
        assert plan.blocks[c] * span >= t.class_rows[c]
    assert sorted(plan.order) == list(range(t.n_classes))
    widths = [t.class_widths[c] for c in plan.order]
    assert widths == sorted(widths, reverse=True)
    return plan


@given(incidence_case())
@settings(max_examples=8)
def test_k1_leaf_plan_equals_pallas_interpret(case):
    _k1_leaf_compare(case)


@pytest.mark.parametrize("monoid", MONOID_NAMES)
def test_k1_leaf_plan_padded_and_zero_degree(monoid):
    rng = np.random.default_rng(13)
    n_src, n_dst, nnz = 70, 120, 900
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = rng.integers(0, n_dst - 30, nnz).astype(np.int32)   # 30 empty
    dst[:300] = rng.integers(0, 3, 300)                       # a few hubs
    mask = (rng.random(nnz) > 0.2).astype(np.float32)
    msg = _payload(rng, monoid, "int32", (n_src, 2))
    case = (src, dst, mask, n_src, n_dst, monoid, msg, rng.random(n_src) > 0.4)
    plan = _k1_leaf_compare(case, pad=True)
    assert plan.zero_dst.numel() >= 30
    assert bool((plan.slot_dst < 0).any())


def test_class_span_follows_row_length():
    # DBLP's fwd classes at full scale: short rows span four tiles, a
    # lane a row; longer rows a tile or less, about four edges a lane.
    assert class_span(1115136, 1048576, 128) == 512
    assert class_span(900096, 262144, 128) == 512
    assert class_span(557568, 65536, 128) == 128
    assert class_span(266752, 8192, 128) == 32
    assert class_span(100, 8, 8) == 128
    assert class_span(0, 0, 128) == 512
    assert class_span(10**6, 96, 96) == 12
    assert class_span(10, 10, 4096) == 512


# --------------------------------------------------------------------------
# the port's delivery lowerings vs the JAX reference deliver
# --------------------------------------------------------------------------

@given(incidence_case())
def test_fused_deliver_lowerings_equal_reference(case):
    src, dst, mask, n_src, n_dst, monoid, msg, active = case
    want = _reference(msg, active, src, dst, n_dst, monoid, mask)
    t, _ = _both_layouts(src, dst, mask, n_src, n_dst)
    for lowering in ("ell", "plain", "cuda"):
        _assert_bitwise(_port(msg, active, t, monoid, lowering), want,
                        (monoid, lowering, msg.dtype))


def test_fused_deliver_float_sum_within_tolerance():
    rng = np.random.default_rng(11)
    n_src, n_dst, nnz = 200, 90, 4000
    src = rng.integers(0, n_src, nnz).astype(np.int32)
    dst = rng.integers(0, n_dst, nnz).astype(np.int32)
    msg = rng.standard_normal((n_src, 4)).astype(np.float32)
    want = _reference(msg, None, src, dst, n_dst, "sum", None)
    t = build_delivery_layout(src, dst, None, n_src, n_dst)
    for lowering in ("ell", "plain", "cuda"):
        np.testing.assert_allclose(_port(msg, None, t, "sum", lowering), want,
                                   rtol=1e-5, atol=1e-5)


def test_cuda_wrapper_on_cpu_takes_plain_and_counts_nothing():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 30, 400).astype(np.int32)
    dst = rng.integers(0, 20, 400).astype(np.int32)
    lay = build_delivery_layout(src, dst, None, 30, 20)
    msgs_aug = torch.as_tensor(rng.standard_normal((31, 2)).astype(
        np.float32))
    before = deliver_fused_cuda.launches
    for c in range(lay.n_classes):
        args = (msgs_aug, None, lay.class_src[c], lay.class_dst[c],
                lay.class_bounds[c], lay.class_rows[c], "max")
        kw = dict(block_n=lay.block_n, block_e=lay.class_block_e[c])
        assert torch.equal(deliver_fused_cuda(*args, **kw),
                           deliver_fused_plain(*args, **kw))
    assert deliver_fused_cuda.launches == before
