"""The port's LM serving path held against the JAX package on the CPU.

Inputs come from numpy seeds; weights are the JAX package's own
``init_params`` carried across with ``params_from_jax``.  Each JAX
function runs once per configuration (under ``jax.jit``) and is cached
for the module.  Covered: every LM ``CONFIG`` and ``smoke()`` field for
field with the derived counts and the shape sets; each ``layers``
function; each attention form beside its JAX twin, the K4 route's
plain GQA form and ``flash_plain`` with fewer KV heads; ``moe_ffn`` on
the global and grouped dispatch; ``forward``, ``prefill`` and a
``serve_step`` sequence of the five smoke configurations in float32 and
bfloat16; the port's own prefill-matches-decode; the launcher's greedy
ids against the JAX loop; ``python -m repro_torch.launch.serve``; the
production mesh helpers on a ``gloo`` world of one.

Tolerances.  Float32: 1e-5 of the reference's largest magnitude (the
two differ by float32 rounding only: reassociated sums, ``1 / sqrt(d)``
as K4 multiplies it).  A value the model stores in bfloat16 (the
prefill's cache) may sit one bfloat16 step off where the float32 values
straddle a rounding boundary: 2**-7 relative.  Bfloat16 compute: 5e-2
of the largest magnitude.  Bfloat16 keeps 8 significant bits; the two
packages round products and elementwise chains at different points
(XLA fuses them; torch rounds each op), and JAX's ``naive_attention``
rounds its scores to bfloat16 before the float32 softmax while the
port's K4 route keeps them in float32 (``models/attention.py``); through
the smoke stacks that reads up to about 2.7e-2.  An MoE router whose
top two experts are nearly tied can pick another expert after such a
step in either package, which changes that token's output, and through
attention the later tokens', by far more than a rounding: so every
bfloat16 run of a model is also held to the float32 reference, and
must be no further from it than twice the reference's own bfloat16
run (relative Frobenius norm); only configs with no router are also
held to the reference's bfloat16 run elementwise.  The aux loss in
bfloat16 obeys the same rule (at least 2e-2 of its size).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jcfg
import repro.configs.base as jbase
import repro.launch.mesh as jmesh
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro.models.moe as jmoe
import repro.models.transformer as jt
import repro_torch.configs as tcfg
import repro_torch.configs.base as tbase
import repro_torch.launch.mesh as tmesh
import repro_torch.models.attention as tattn
import repro_torch.models.layers as tlayers
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as tt
from repro.kernels.flash.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash import attention_ref, flash_plain
from repro_torch.launch import serve as tserve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = [a for a in tcfg.ARCH_IDS
         if tcfg.get_config(a, True).family == "lm"]
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_REL = 1e-5
BF16_STEP = 2.0**-7
BF16_REL = 5e-2
AUX_REL = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _close(got, want, dtype, what=""):
    """``got`` within the module's tolerance of ``want``: float32 1e-5,
    bfloat16 5e-2, of the largest magnitude."""
    lim = F32_REL if dtype == "float32" else BF16_REL
    assert _rel(got, want) <= lim, (what, _rel(got, want))


def _bf16_stored(got, want, what=""):
    """Values stored in bfloat16 from float32 results: within float32's
    1e-5 of the largest magnitude, or one bfloat16 step apart where a
    rounding boundary lies between."""
    g, w = _np(got), _np(want)
    lim = BF16_STEP * np.maximum(np.abs(g), np.abs(w)) + F32_REL * np.abs(
        w).max()
    assert not (np.abs(g - w) > lim).any(), (what, np.abs(g - w).max())


def _fro(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _bf16_vs_f32(got16, ref16, ref32, moe, what=""):
    """A bfloat16 result held to the float32 one: the port's bfloat16 run
    is no further from the reference's float32 answer than twice the
    reference's own bfloat16 run (relative Frobenius norm); for a config
    with no router, also within 5e-2 of the reference's bfloat16 run at
    every element (of the largest magnitude)."""
    mine, theirs = _fro(got16, ref32), _fro(ref16, ref32)
    assert mine <= 2 * theirs, (what, mine, theirs)
    if not moe:
        _close(got16, ref16, "bfloat16", what=what)


def _jit(fn, **static):
    """``fn`` under ``jax.jit`` with ``static`` bound."""
    return jax.jit(functools.partial(fn, **static))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    return jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def _fields(obj):
    """A dataclass as a dict, with the compute type by name."""
    out = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if dataclasses.is_dataclass(val):
            val = _fields(val)
        elif isinstance(val, dict):
            val = {k: _fields(v) if dataclasses.is_dataclass(v) else v
                   for k, v in val.items()}
        elif f.name == "compute_dtype":
            val = jnp.dtype(val).name if not isinstance(
                val, torch.dtype) else str(val).removeprefix("torch.")
        out[f.name] = val
    return out


def test_arch_ids_are_the_reference_lm_ids():
    lm = [a for a in jcfg.ARCH_IDS
          if jcfg.get_config(a, smoke=True).family == "lm"]
    assert ARCHS == lm
    # The port runs every id of the reference, in its order (the GNN
    # side and bert4rec too).
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_for_field(arch, smoke):
    got, want = tcfg.get_config(arch, smoke), jcfg.get_config(arch, smoke)
    assert _fields(got) == _fields(want)
    assert got.model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_derived_counts(arch, smoke):
    got = tcfg.get_config(arch, smoke).model
    want = jcfg.get_config(arch, smoke).model
    assert got.period == want.period
    assert got.layer_kinds == want.layer_kinds
    assert got.n_periods == want.n_periods
    assert tt.param_count(got) == jt.param_count(want)
    assert tt.active_param_count(got) == jt.active_param_count(want)
    assert got.flops_per_token() == want.flops_per_token()


def test_llama3_2_1b_full_width_counts():
    cfg = tcfg.get_config("llama3.2-1b").model
    assert tt.param_count(cfg) == 1_235_814_400
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (16, 2048, 32, 8, 64,
                                                   8192, 128_256)


@pytest.mark.parametrize("long_skip,accum", [(None, 8), ("smoke", 2)])
def test_shape_sets(long_skip, accum):
    got = tbase.lm_shapes(long_skip=long_skip, train_accum=accum)
    want = jbase.lm_shapes(long_skip=long_skip, train_accum=accum)
    assert {k: _fields(v) for k, v in got.items()} == {
        k: _fields(v) for k, v in want.items()}
    for mine, ref in ((tbase.GNN_SHAPES, jbase.GNN_SHAPES),
                      (tbase.RECSYS_SHAPES, jbase.RECSYS_SHAPES)):
        assert {k: _fields(v) for k, v in mine.items()} == {
            k: _fields(v) for k, v in ref.items()}


def test_arch_ids_are_the_reference_ids_in_full():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert not tcfg._NOT_PORTED
    for smoke in (False, True):
        assert {a: s.family for a, s in tcfg.all_configs(smoke).items()} \
            == {a: s.family for a, s in jcfg.all_configs(smoke).items()}


@pytest.mark.parametrize("smoke", [False, True])
def test_bert4rec_config_field_for_field(smoke):
    got = tcfg.get_config("bert4rec", smoke)
    want = jcfg.get_config("bert4rec", smoke)
    assert got.family == want.family == "recsys"
    assert _fields(got) == _fields(want)
    assert got.model.compute_dtype == torch.float32
    assert (got.model.vocab, got.model.mask_id) == (want.model.vocab,
                                                     want.model.mask_id)


def test_all_configs_are_the_lm_ones():
    specs = tcfg.all_configs(smoke=True)
    assert {a for a, s in specs.items() if s.family == "lm"} == set(ARCHS)
    assert {s.family for s in specs.values()} == {"lm", "gnn", "recsys"}


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_unembed(dtype):
    jd, td = DT[dtype]
    w, x, tbl = _rand((48, 80), 1, 0.2), _rand((2, 5, 48), 2), _rand(
        (64, 48), 3, 0.2)
    _close(tlayers.dense({"w": _t(w)}, _t(x), td),
           jlayers.dense({"w": _j(w)}, _j(x), jd), dtype)
    _close(tlayers.unembed({"table": _t(tbl)}, _t(x), td),
           jlayers.unembed({"table": _j(tbl)}, _j(x), jd), dtype)


def test_cast_weight_is_kept_and_follows_in_place_changes():
    w = torch.nn.Parameter(_t(_rand((8, 4), 4)), requires_grad=False)
    first = tlayers.cast_weight(w, torch.bfloat16)
    assert tlayers.cast_weight(w, torch.bfloat16) is first
    assert torch.equal(first, w.to(torch.bfloat16))
    with torch.no_grad():
        w.mul_(2.0)
    again = tlayers.cast_weight(w, torch.bfloat16)
    assert again is not first and torch.equal(again, w.to(torch.bfloat16))
    assert tlayers.cast_weight(w, torch.float32) is w
    tree = tlayers.ParamTree({"a": {"w": w.detach()}})
    kept = tree["a"]["w"]
    tlayers.cast_weight(kept, torch.bfloat16)
    assert hasattr(kept, "_compute_cast")
    tlayers.release_casts(tree)
    assert not hasattr(kept, "_compute_cast")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm(dtype):
    jd, td = DT[dtype]
    x = _rand((3, 7, 32), 5, 3.0)
    scale, bias = _rand((32,), 6) + 1.0, _rand((32,), 7)
    _close(tlayers.rmsnorm({"scale": _t(scale)}, _t(x, td)),
           jlayers.rmsnorm({"scale": _j(scale)}, _j(x, jd)), dtype)
    _close(tlayers.layernorm({"scale": _t(scale), "bias": _t(bias)},
                             _t(x, td)),
           jlayers.layernorm({"scale": _j(scale), "bias": _j(bias)},
                             _j(x, jd)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    jd, td = DT[dtype]
    p = {k: _rand(s, i, 0.2) for i, (k, s) in enumerate(
        (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32))))}
    x = _rand((2, 6, 32), 9)
    _close(tlayers.swiglu({k: _t(v) for k, v in p.items()}, _t(x), td),
           jlayers.swiglu({k: _j(v) for k, v in p.items()}, _j(x), jd),
           dtype)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype, theta):
    jd, td = DT[dtype]
    x = _rand((2, 40, 4, 16), 10)
    pos = np.arange(40, dtype=np.int32)[None] + 4000
    got = tlayers.rope(_t(x, td), _t(pos), theta)
    want = jlayers.rope(_j(x, jd), _j(pos), theta)
    assert got.dtype == td
    _close(got, want, dtype)


def test_embed_takes_rows_and_fills_ids_out_of_range_as_the_reference():
    tbl = _rand((10, 6), 11)
    ids = np.array([[0, 9, -1, -10], [10, -11, 3, 1000]], np.int32)
    got = tlayers.embed({"table": _t(tbl)}, _t(ids), torch.float32)
    want = np.asarray(jlayers.embed({"table": _j(tbl)}, _j(ids),
                                    jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)  # NaN where JAX's
    assert np.isnan(want[1, :2]).all() and not np.isnan(want[0]).any()
    in_range = ids[0:1]
    np.testing.assert_array_equal(
        tlayers.embed({"table": _t(tbl)}, _t(in_range)).float().numpy(),
        _np(jlayers.embed({"table": _j(tbl)}, _j(in_range))))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    logits, labels = _rand((2, 9, 30), 12, 3.0), np.random.default_rng(
        13).integers(0, 30, (2, 9))
    mask = (np.random.default_rng(14).random((2, 9)) > 0.3).astype(
        np.float32) if masked else None
    got = tlayers.cross_entropy(_t(logits), _t(labels),
                                None if mask is None else _t(mask))
    want = jlayers.cross_entropy(_j(logits), _j(labels),
                                 None if mask is None else _j(mask))
    assert _rel(got, want) <= F32_REL


@pytest.mark.parametrize("tied,chunk", [(True, 4), (False, 4), (True, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_unembed_cross_entropy(dtype, tied, chunk):
    jd, td = DT[dtype]
    d, v = 24, 50
    table = _rand((v, d) if tied else (d, v), 15, 0.3)
    x, labels = _rand((2, 8, d), 16), np.random.default_rng(17).integers(
        0, v, (2, 8))
    mask = (np.random.default_rng(18).random((2, 8)) > 0.2).astype(
        np.float32)
    got = tlayers.fused_unembed_cross_entropy(
        _t(table), _t(x), _t(labels), _t(mask), chunk=chunk,
        compute_dtype=td)
    want = _jit(jlayers.fused_unembed_cross_entropy, chunk=chunk,
                compute_dtype=jd)(_j(table), _j(x), _j(labels), _j(mask))
    assert _rel(got, want) <= F32_REL


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _qkv(b, s, h, kvh, d, seed, dtype, sk=None):
    sk = s if sk is None else sk
    return (_rand((b, s, h, d), seed), _rand((b, sk, kvh, d), seed + 1),
            _rand((b, sk, kvh, d), seed + 2))


def _both(fn_t, fn_j, arrays, dtype, **kw):
    jd, td = DT[dtype]
    got = fn_t(*(_t(a, td) for a in arrays), **kw)
    want = _jit(fn_j, **kw)(*(_j(a, jd) for a in arrays))
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    return got, want


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=5),
                                dict(causal=True, q_offset=3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_naive_attention(dtype, kw):
    arrays = _qkv(2, 12, 8, 2, 16, 20, dtype, sk=15 if "q_offset" in kw
                  else None)
    got, want = _both(tattn.naive_attention, jattn.naive_attention, arrays,
                      dtype, **kw)
    _close(got, want, dtype)


# S = 45 is no multiple of the block (16): the last block is padded.
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=10),
                                dict(causal=True, q_offset=20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_attention(dtype, kw):
    sq = 25 if "q_offset" in kw else 45
    arrays = _qkv(2, sq, 6, 3, 16, 30, dtype, sk=45)
    for use_scan in (True, False):
        got, want = _both(tattn.blocked_attention, jattn.blocked_attention,
                          arrays, dtype, block_size=16, use_scan=use_scan,
                          **kw)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_local_attention(dtype):
    arrays = _qkv(2, 32, 4, 2, 16, 40, dtype)
    got, want = _both(tattn.chunked_local_attention,
                      jattn.chunked_local_attention, arrays, dtype, window=8)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype, window):
    jd, td = DT[dtype]
    q, k, v = _qkv(2, 1, 8, 2, 16, 50, dtype, sk=20)
    for cache_len in (1, 13, 20):
        got = tattn.decode_attention(_t(q, td), _t(k, torch.bfloat16),
                                     _t(v, torch.bfloat16), cache_len,
                                     window=window)
        want = _jit(jattn.decode_attention, window=window)(
            _j(q, jd), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
            jnp.int32(cache_len))
        _close(got, want, dtype)


@pytest.mark.parametrize("s", [40, 130])
def test_k4_route_matches_the_reference_blocked_form_in_bf16(s):
    """The route's plain GQA form (``flash_plain`` under
    ``causal_attention`` on the CPU) against JAX's ``blocked_attention``,
    which also keeps float32 scores and rounds ``p`` to bfloat16."""
    arrays = _qkv(2, s, 8, 2, 32, 60, "bfloat16")
    got = tattn.causal_attention(*(_t(a, torch.bfloat16) for a in arrays))
    want = _jit(jattn.blocked_attention, causal=True, block_size=64)(
        *(_j(a, jnp.bfloat16) for a in arrays))
    _close(got, want, "bfloat16")
    f32 = tattn.causal_attention(*(_t(a) for a in arrays))
    _close(f32, jax.jit(jattn.naive_attention)(*(_j(a) for a in arrays)),
           "float32")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh", [(8, 2), (6, 6), (4, 1)])
def test_flash_plain_gqa_equals_attention_ref_on_expanded_heads(h, kvh,
                                                                causal):
    rng = np.random.default_rng(h * 10 + kvh)
    q = rng.standard_normal((2, h, 70, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, kvh, 70, 16)).astype(np.float32)
            for _ in range(2))
    got = flash_plain(_t(q), _t(k), _t(v), causal=causal, block_q=32,
                      block_k=16)
    rep = h // kvh
    kx, vx = (np.repeat(a, rep, axis=1) for a in (k, v))
    want_t = attention_ref(_t(q), _t(kx), _t(vx), causal=causal)
    want_j = j_attention_ref(_j(q), _j(kx), _j(vx), causal=causal)
    _close(got, want_t, "float32")
    _close(got, want_j, "float32")


def test_flash_plain_refuses_kv_heads_that_do_not_divide():
    q = torch.zeros(1, 6, 4, 8)
    kv = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="multiple of the KV heads"):
        flash_plain(q, kv, kv)
    with pytest.raises(ValueError, match="KvH, Sk, D"):
        flash_plain(q, kv, kv[..., :4])


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

MOE_CASES = {
    # global dispatch (t < 64 E) with drops at capacity factor 1.0
    "global": (tmoe.MoEConfig(n_experts=4, top_k=2, d_ff=32,
                              capacity_factor=1.0), (2, 24)),
    # grouped: t = 512 >= 64 E, four groups
    "grouped": (tmoe.MoEConfig(n_experts=8, top_k=2, d_ff=16, n_groups=4),
                (4, 128)),
    "shared": (tmoe.MoEConfig(n_experts=4, top_k=1, d_ff=32,
                              n_shared_experts=1, n_groups=2), (2, 128)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn(case, dtype):
    jd, td = DT[dtype]
    cfg, (b, s) = MOE_CASES[case]
    jcfg_ = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    d = 32
    params = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(3), jcfg_, d))
    x = _rand((b, s, d), 70)
    y_t, aux_t = tmoe.moe_ffn(jax.tree.map(_t, params), _t(x, td), cfg, td)
    run = {dt: _jit(jmoe.moe_ffn, cfg=jcfg_, compute_dtype=dt)(
        jax.tree.map(_j, params), _j(x, dt)) for dt in {jd, jnp.float32}}
    y_j, aux_j = run[jd]
    assert y_t.dtype == td
    if dtype == "float32":
        _close(y_t, y_j, dtype, case)
        for key in ("lb_loss", "z_loss"):
            assert _rel(aux_t[key], aux_j[key]) <= F32_REL, key
        return
    y32, aux32 = run[jnp.float32]
    _bf16_vs_f32(y_t, y_j, y32, True, case)
    for key in ("lb_loss", "z_loss"):
        _aux_close(aux_t[key], aux_j[key], aux32[key], key)


def _aux_close(got16, ref16, ref32, what=""):
    """The bfloat16 aux loss: as far from the float32 one as twice the
    reference's bfloat16 one, or 2e-2 of its size."""
    err = abs(float(got16) - float(ref32))
    lim = max(2 * abs(float(ref16) - float(ref32)),
              AUX_REL * abs(float(ref32)))
    assert err <= lim, (what, float(got16), float(ref16), float(ref32))


def test_moe_capacity_and_dispatch_slots():
    cfg = tmoe.MoEConfig(n_experts=4, top_k=2, d_ff=8, capacity_factor=0.5)
    jc = jmoe.MoEConfig(**dataclasses.asdict(cfg))
    for t in (1, 7, 64, 1000):
        assert tmoe.capacity(cfg, t) == jmoe.capacity(jc, t)
    xt, logits = _rand((24, 8), 71), _rand((24, 4), 72)
    cap = tmoe.capacity(cfg, 24)
    x_t, aux_t = tmoe._dispatch_group(_t(xt), _t(logits), cfg, cap)
    x_j, aux_j = _jit(jmoe._dispatch_group, cfg=jc, cap=cap)(_j(xt),
                                                           _j(logits))
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    # dest, token_of_slot, slot_w, keep, flat_e: the slots exactly, the
    # weights to float32's softmax rounding.
    for i, (got, want) in enumerate(zip(aux_t[:5], aux_j[:5])):
        if i == 2:
            assert _rel(got, want) <= F32_REL
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (aux_t[0] == 4 * cap).any()  # some slots dropped


# --------------------------------------------------------------------------
# the model: forward, prefill, serve_step
# --------------------------------------------------------------------------

B, S, STEPS = 2, 32, 8
_RUNS = {}


def _configs(arch, dtype):
    jd, td = DT[dtype]
    return (dataclasses.replace(jcfg.get_config(arch, True).model,
                                compute_dtype=jd),
            dataclasses.replace(tcfg.get_config(arch, True).model,
                                compute_dtype=td))


_PARAMS = {}


def _jax_params(arch):
    """Weights of ``arch``'s smoke config in the JAX package's pytree
    (shapes from ``jax.eval_shape`` of its ``init_params``; values from a
    numpy seed in its scales: fan-in**-0.5, the embedding's d**-0.5,
    norms at 1), float32 for either compute type, once per module."""
    if arch not in _PARAMS:
        jc = jcfg.get_config(arch, True).model
        shapes = jax.eval_shape(lambda k: jt.init_params(k, jc),
                                jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)

        def draw(path, leaf):
            name = jax.tree_util.keystr(path)
            if len(leaf.shape) == 1 or name.endswith("['scale']"):
                return np.ones(leaf.shape, np.float32)
            fan = leaf.shape[-1] if name.endswith("['table']") else (
                leaf.shape[-2])
            return (rng.standard_normal(leaf.shape) * fan**-0.5).astype(
                np.float32)

        np_params = jax.tree_util.tree_map_with_path(draw, shapes)
        _PARAMS[arch] = (jax.tree.map(jnp.asarray, np_params), np_params)
    return _PARAMS[arch]


def _run(arch, dtype):
    """Both packages' forward, prefill and a serve_step sequence on the
    same weights and tokens, once per module."""
    key = (arch, dtype)
    if key in _RUNS:
        return _RUNS[key]
    jc, tc = _configs(arch, dtype)
    params, np_params = _jax_params(arch)
    tparams = tt.params_from_jax(np_params, tc, device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)).astype(
        np.int32)
    cache_dt = DT[dtype]
    ref = {}
    ref["logits"], ref["aux"] = jax.jit(
        lambda p, t: jt.forward(p, jc, t))(params, toks)
    ref["last"], ref["cache"] = jax.jit(
        lambda p, t: jt.prefill(p, jc, t))(params, toks)
    step = jax.jit(lambda p, c, tok, pos: jt.serve_step(p, jc, c, tok, pos))
    cache = jt.init_cache(jc, B, STEPS, dtype=cache_dt[0])
    ref["steps"] = []
    for i in range(STEPS):
        lg, cache = step(params, cache, toks[:, i], jnp.int32(i))
        ref["steps"].append(lg)
    ref["step_cache"] = cache
    got = {}
    tok = torch.from_numpy(toks).long()
    with torch.no_grad():
        got["logits"], got["aux"] = tt.forward(tparams, tc, tok)
        got["last"], got["cache"] = tt.prefill(tparams, tc, tok)
        cache = tt.init_cache(tc, B, STEPS, dtype=cache_dt[1], device="cpu")
        got["steps"] = []
        for i in range(STEPS):
            lg, cache = tt.serve_step(tparams, tc, cache, tok[:, i], i)
            got["steps"].append(lg)
        got["step_cache"] = cache
    _RUNS[key] = (tc, ref, got)
    return _RUNS[key]


def _model_close(arch, dtype, pick, what, stored=False):
    """``pick(results)`` of the port against the reference's: float32 at
    1e-5 (a bfloat16-stored value to one step); bfloat16 by
    ``_bf16_vs_f32`` against the float32 runs."""
    tc, ref, got = _run(arch, dtype)
    if dtype == "float32":
        if stored:
            _bf16_stored(pick(got), pick(ref), what)
        else:
            _close(pick(got), pick(ref), dtype, what)
        return
    _, ref32, _ = _run(arch, "float32")
    _bf16_vs_f32(pick(got), pick(ref), pick(ref32), tc.moe is not None,
                 what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch, dtype):
    tc, ref, got = _run(arch, dtype)
    assert got["logits"].shape == (B, S, tc.vocab)
    assert got["logits"].dtype == DT[dtype][1]
    _model_close(arch, dtype, lambda r: r["logits"], "logits")
    if tc.moe is None:
        assert float(got["aux"]) == float(ref["aux"]) == 0.0
    elif dtype == "float32":
        assert _rel(got["aux"], ref["aux"]) <= F32_REL
    else:
        _aux_close(got["aux"], ref["aux"], _run(arch, "float32")[1]["aux"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch, dtype):
    tc, ref, got = _run(arch, dtype)
    assert got["last"].shape == (B, tc.vocab)
    _model_close(arch, dtype, lambda r: r["last"], "last logits")
    for key in ("k", "v"):
        assert got["cache"][key].dtype == torch.bfloat16
        assert tuple(got["cache"][key].shape) == tuple(
            ref["cache"][key].shape) == (tc.n_layers, B, S, tc.n_kv_heads,
                                         tc.head_dim)
        _model_close(arch, dtype, lambda r: r["cache"][key], key,
                     stored=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_sequence_matches_the_reference(arch, dtype):
    for i in range(STEPS):
        _model_close(arch, dtype, lambda r: r["steps"][i], f"step {i}")
    for key in ("k", "v"):
        _model_close(arch, dtype, lambda r: r["step_cache"][key], key)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_matches_its_decode(arch):
    """``tests/test_models_lm.py::test_prefill_matches_decode``'s property
    on the port: token-by-token decode reproduces prefill's last logits
    (float32, unbounded MoE capacity, 2e-4)."""
    cfg = _configs(arch, "float32")[1]
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=64.0))
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    s = 16
    toks = torch.randint(0, cfg.vocab, (2, s),
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        last, _ = tt.prefill(params, cfg, toks)
        cache = tt.init_cache(cfg, 2, s, dtype=torch.float32, device="cpu")
        for t in range(s):
            logits, cache = tt.serve_step(params, cfg, cache, toks[:, t], t)
    np.testing.assert_allclose(logits.numpy(), last.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_serve_step_takes_a_position_tensor():
    """``pos`` as a 0-d tensor (``index_copy_``) gives the bits of ``pos``
    as a host int (a slice written in place)."""
    cfg = _configs("gemma3-12b", "float32")[1]
    params = tt.init_params(torch.Generator().manual_seed(3), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 10),
                         generator=torch.Generator().manual_seed(4))
    out = []
    with torch.no_grad():
        for as_tensor in (False, True):
            cache = tt.init_cache(cfg, 2, 10, device="cpu")
            for t in range(10):
                pos = torch.tensor(t) if as_tensor else t
                logits, cache = tt.serve_step(params, cfg, cache, toks[:, t],
                                              pos)
            out.append((logits, cache["k"]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_loss_fn_matches_the_reference():
    jc, tc = _configs("qwen3-moe-235b-a22b", "float32")
    params, np_params = _jax_params("qwen3-moe-235b-a22b")
    tparams = tt.params_from_jax(np_params, tc, device="cpu")
    toks = np.random.default_rng(5).integers(0, jc.vocab, (2, 16))
    want = jax.jit(lambda p, b: jt.loss_fn(p, jc, b))(
        params, {"tokens": _j(toks), "labels": _j(toks)})
    with torch.no_grad():
        got = tt.loss_fn(tparams, tc, {"tokens": _t(toks),
                                       "labels": _t(toks)})
    assert _rel(got, want) <= F32_REL


def test_params_from_jax_unstacks_the_periods():
    jc, tc = _configs("llama4-maverick-400b-a17b", "float32")
    params = _jax_params("llama4-maverick-400b-a17b")[1]
    tp = tt.params_from_jax(params, tc, device="cpu")
    assert len(tp["layers"]) == tc.n_layers == 4 and tc.period == 4
    for i, lp in enumerate(tp["layers"]):
        p, j = divmod(i, tc.period)
        assert ("moe" in lp) == tc.layer_kinds[j][1]
        np.testing.assert_array_equal(lp["wq"]["w"].numpy(),
                                      params["layers"][j]["wq"]["w"][p])
    np.testing.assert_array_equal(tp["lm_head"]["w"].numpy(),
                                  params["lm_head"]["w"])
    np.testing.assert_array_equal(
        tp["layers"][1]["moe"]["shared"]["w_up"].numpy(),
        params["layers"][1]["moe"]["shared"]["w_up"][0])
    assert all(not p.requires_grad for p in tp.parameters())
    n = sum(p.numel() for p in tp.parameters())
    assert n == tt.param_count(tc)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b"])
def test_launcher_greedy_ids_equal_the_reference_loop(arch):
    """``launch.serve.generate`` (prefill, the bf16 cache moved into a
    full-length one, greedy serve_step) against the JAX launcher's loop,
    float32 compute, on carried weights and the same prompts."""
    jc, tc = _configs(arch, "float32")
    params, np_params = _jax_params(arch)
    tparams = tt.params_from_jax(np_params, tc, device="cpu")
    s, gen = 16, 6
    prompts = np.random.default_rng(8).integers(0, jc.vocab, (3, s))
    logits, warm = jax.jit(lambda p, t: jt.prefill(p, jc, t))(
        params, _j(prompts))
    cache = jt.init_cache(jc, 3, s + gen, dtype=warm["k"].dtype)
    cache = {k: jax.lax.dynamic_update_slice_in_dim(cache[k], warm[k], 0,
                                                    axis=2) for k in cache}
    tok = jnp.argmax(logits, axis=-1)
    want = [tok]
    step = jax.jit(lambda p, c, t, pos: jt.serve_step(p, jc, c, t, pos))
    for i in range(gen - 1):
        logits, cache = step(params, cache, tok, jnp.int32(s + i))
        tok = jnp.argmax(logits, axis=-1)
        want.append(tok)
    with torch.no_grad():
        got, timing = tserve.generate(tparams, tc, _t(prompts).long(), gen)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))
    assert timing["steps"] == gen - 1


def test_launcher_prints_its_three_lines_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "command-r-plus-104b", "--batch", "2", "--prompt-len",
         "8", "--gen", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill: ") and "for 2x8 tokens" in lines[0]
    assert lines[1].startswith("decode:  ") and "for 3 steps" in lines[1]
    assert lines[2].startswith("generated ids [batch 0]: [")
    assert len(eval(lines[2].split(": ", 1)[1])) == 4


def test_launcher_takes_smoke_and_no_smoke():
    assert tserve.parse_args([]).smoke is True
    full = tserve.parse_args(["--arch", "llama3.2-1b", "--no-smoke"])
    assert full.smoke is False and full.device is None
    assert tserve.build("llama3.2-1b", smoke=True, device="cpu")[
        0].d_model == 64
    assert tcfg.get_config(full.arch, smoke=full.smoke).model.d_model == 2048


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_launcher_runs_on_the_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "llama3.2-1b", "--batch", "1",
                     "--prompt-len", "4", "--gen", "2"])


# --------------------------------------------------------------------------
# the production mesh helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_on_a_small_world(multi_pod):
    need = 512 if multi_pod else 256
    with pytest.raises(RuntimeError, match=f"needs {need} devices but only"):
        tmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match=f"needs {need} devices but only"):
        jmesh.make_production_mesh(multi_pod=multi_pod)


def test_mesh_axes_on_a_gloo_world_of_one(tmp_path):
    from torch.distributed.device_mesh import DeviceMesh

    tmesh.init_local_group(0, 1, str(tmp_path / "store"), "cpu",
                           timeout_s=30.0)
    try:
        with pytest.raises(RuntimeError, match="needs 256 devices but only "
                                               "1 are visible"):
            tmesh.make_production_mesh()
        jdev = np.array(jax.devices()[:1])
        for names in (("data",), ("data", "model"),
                      ("pod", "data", "model")):
            shape = (1,) * len(names)
            mine = DeviceMesh("cpu", torch.zeros(shape, dtype=torch.long),
                              mesh_dim_names=names)
            ref = jax.sharding.Mesh(jdev.reshape(shape), names)
            assert tmesh.dp_axes(mine) == jmesh.dp_axes(ref)
            assert tmesh.flat_axes(mine) == jmesh.flat_axes(ref)
            assert tmesh.total_devices(mine) == jmesh.total_devices(ref) == 1
        host = tmesh.make_host_mesh()
        assert tmesh.dp_axes(host) == ("data",)
        assert tmesh.total_devices(host) == 1
    finally:
        dist.destroy_process_group()


def test_constrain_checks_the_rank_and_returns_x():
    from repro_torch.models.sharding import _divides, _resolve, constrain

    x = torch.zeros(2, 3, 4)
    assert constrain(x, "dp", None, "tp") is x
    assert constrain(None, "dp") is None
    with pytest.raises(ValueError, match="2 axes for rank-3"):
        constrain(x, "dp", None)

    class Mesh:  # the DeviceMesh surface _resolve/_divides read
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 4, 8)[i]

    m = Mesh()
    assert _resolve(m, "dp") == ("pod", "data")
    assert _resolve(m, "tp") == "model"
    assert _resolve(m, "flat") == ("pod", "data", "model")
    assert _resolve(m, None) is None and _resolve(m, "other") is None
    assert _divides(16, ("pod", "data"), m) and not _divides(12, "model", m)
