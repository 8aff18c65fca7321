"""The port's training substrate held against the JAX package on the CPU:
AdamW (``schedule``, ``global_norm``, ``adamw_update``), the checkpoint
contract (the six properties of ``tests/test_checkpoint.py`` on the
port, and the manifest's keys against one the JAX package wrote), K4's
plain backward against ``jax.grad`` of the JAX package's
``naive_attention``, the autograd ``Function`` against autograd through
``flash_plain``, and the launcher ``repro_torch.launch.train``.

Inputs come from numpy seeds and go to both packages.  Tolerances: the
optimizer's arithmetic is float32 in both (1e-6 relative: the two
round ``b1 ** step`` and fused products differently); attention
gradients in float32 within 1e-5 of each tensor's largest magnitude
(reassociated sums over key blocks).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.train as jtrain
from repro_torch.kernels.flash import (
    flash_attention,
    flash_bwd_plan,
    flash_plain,
    flash_plain_backward,
)
from repro_torch.kernels.flash.flash import SMEM_LIMIT
from repro_torch.launch import train as ltrain
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    schedule,
)
from repro_torch.train.tree import leaves

OPT_REL = 1e-6
ATTN_REL = 1e-5


def _rel(got, want) -> float:
    g = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float64))
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _np_tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}, "e": (7,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        x = rng.standard_normal(s).astype(np.float32) * scale
        return np.abs(x) if positive else x

    return draw(shapes)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10000])
def test_schedule_matches_the_reference(step):
    cfg = AdamWConfig()
    want = float(jtrain.schedule(jtrain.AdamWConfig(), jnp.int32(step)))
    got = schedule(cfg, step)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=OPT_REL)
    np.testing.assert_allclose(
        schedule(cfg, torch.tensor(step, dtype=torch.int32)).item(), want,
        rtol=OPT_REL)


def test_global_norm_matches_the_reference():
    tree = _np_tree(1)
    want = float(jtrain.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm(_to_torch(tree))
    np.testing.assert_allclose(got.item(), want, rtol=OPT_REL)


# (gradient scale, step before the update): a clipped gradient (norm
# far above grad_clip) and an unclipped one, at the first step and later.
@pytest.mark.parametrize("gscale,step", [(10.0, 0), (1e-2, 0), (10.0, 6),
                                         (1e-2, 150)])
def test_adamw_update_matches_the_reference(gscale, step):
    cfg = AdamWConfig(total_steps=200)
    params, grads = _np_tree(2), _np_tree(3, gscale)
    mu, nu = _np_tree(4, 0.1), _np_tree(5, 0.01, positive=True)
    jstate = {"mu": jax.tree.map(jnp.asarray, mu),
              "nu": jax.tree.map(jnp.asarray, nu), "step": jnp.int32(step)}
    jp, jopt, jm = jax.jit(
        lambda g, s, p: jtrain.adamw_update(jtrain.AdamWConfig(
            total_steps=200), g, s, p))(
        jax.tree.map(jnp.asarray, grads), jstate,
        jax.tree.map(jnp.asarray, params))
    tp = _to_torch(params)
    opt = adamw_init(tp)
    for dst, src in ((opt["mu"], mu), (opt["nu"], nu)):
        for a, b in zip(_flat(dst), _flat(src)):
            a.copy_(torch.from_numpy(b))
    opt["step"].fill_(step)
    before = [x.data_ptr() for x in _flat(tp)]
    got_p, got_opt, got_m = adamw_update(cfg, _to_torch(grads), opt, tp)
    assert got_p is tp and [x.data_ptr() for x in _flat(tp)] == before
    assert int(got_opt["step"]) == int(jopt["step"]) == step + 1
    for name, g, w in (("params", got_p, jp), ("mu", got_opt["mu"],
                                               jopt["mu"]),
                       ("nu", got_opt["nu"], jopt["nu"])):
        for a, b in zip(_flat(g), _flat(w)):
            assert _rel(a, b) <= OPT_REL, name
    for key in ("grad_norm", "lr"):
        assert got_m[key].dim() == 0
        np.testing.assert_allclose(got_m[key].item(), float(jm[key]),
                                   rtol=OPT_REL)


def test_adamw_init_is_float32_zeros_in_the_params_tree():
    from repro_torch.models.transformer import Transformer

    tp = Transformer({"embed": {"table": torch.ones(4, 2)},
                      "layers": [{"w": torch.ones(3)}]})
    opt = adamw_init(tp)
    assert isinstance(opt["mu"], Transformer)
    assert [n for n, _ in opt["mu"].named_parameters()] == [
        n for n, _ in tp.named_parameters()]
    assert all(p.dtype == torch.float32 and not p.any()
               for p in opt["nu"].parameters())
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0


# --------------------------------------------------------------------------
# checkpoints: tests/test_checkpoint.py's six properties on the port
# --------------------------------------------------------------------------

def _fresh():
    """llama3.2-1b smoke, the launcher's state from seed 0 and its step."""
    cfg, state = ltrain.build("llama3.2-1b", smoke=True, device="cpu")
    return cfg, state, ltrain.make_step(cfg, total_steps=20)


def _trees_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip_bit_exact(tmp_path):
    cfg, state, _ = _fresh()
    path = save_checkpoint(str(tmp_path), 3, state)
    restored, s = restore_checkpoint(path, state)
    assert s == 3
    assert _trees_equal(state, restored)
    assert all(p.requires_grad for p in restored.params.parameters())
    assert type(restored.params) is type(state.params)


def test_latest_checkpoint_ordering(tmp_path):
    _, state, _ = _fresh()
    d = str(tmp_path)
    save_checkpoint(d, 1, state)
    save_checkpoint(d, 12, state)
    save_checkpoint(d, 3, state)
    assert latest_checkpoint(d).endswith("step_00000012")


def test_corruption_detected(tmp_path):
    _, state, _ = _fresh()
    path = save_checkpoint(str(tmp_path), 1, state)
    victim = os.path.join(path, "leaf_00000.npy")
    arr = np.load(victim)
    flat = arr.reshape(-1)
    flat[0] = flat[0] + 1.0 if arr.dtype.kind == "f" else 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="corrupt"):
        restore_checkpoint(path, state)


def test_shape_mismatch_rejected(tmp_path):
    _, state, _ = _fresh()
    path = save_checkpoint(str(tmp_path), 1, state)
    bad = {"params": [torch.zeros(t.shape + (1,)) for t in leaves(state)]}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, bad, verify=False)
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, {"x": torch.zeros(1)}, verify=False)


def test_resume_is_bit_exact(tmp_path):
    """Crash/restart at step 2 of 4 reproduces the uninterrupted run."""

    def run(state, step_fn, cfg, lo, hi):
        for i in range(lo, hi):
            state, _ = step_fn(state, ltrain.synthetic_batch(
                cfg.vocab, 2, 16, i, device="cpu"))
        return state

    cfg, state, step_fn = _fresh()
    straight = run(state, step_fn, cfg, 0, 4)
    cfg, state, step_fn = _fresh()
    half = run(state, step_fn, cfg, 0, 2)
    path = save_checkpoint(str(tmp_path), 2, half)
    recovered, s = restore_checkpoint(path, half)
    resumed = run(recovered, step_fn, cfg, s, 4)
    assert int(resumed.opt_state["step"]) == 4
    assert _trees_equal(straight, resumed)


def test_atomic_write_no_partial(tmp_path):
    _, state, _ = _fresh()
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000099.tmp"), exist_ok=True)
    save_checkpoint(d, 5, state)
    assert latest_checkpoint(d).endswith("step_00000005")


def test_manifest_keys_match_one_the_reference_wrote(tmp_path):
    """The manifest's keys, and each leaf entry's, key for key, against
    the JAX package's on a TrainState of its own; the leaf names in its
    key-path spelling."""
    import json

    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray,
                                                  _np_tree(6)))
    jpath = jtrain.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    _, state, _ = _fresh()
    tpath = save_checkpoint(str(tmp_path / "torch"), 1, state)
    j, t = (json.load(open(os.path.join(p, "manifest.json")))
            for p in (jpath, tpath))
    assert list(t) == list(j)
    for leaf in t["leaves"]:
        assert list(leaf) == list(j["leaves"][0])
    assert sorted(os.listdir(tpath))[0] == sorted(os.listdir(jpath))[0]
    names = [x["name"] for x in t["leaves"]]
    assert ".params/['embed']/['table']" in names
    assert ".opt_state/['step']" in names
    assert ".opt_state/['mu']/['layers']/[1]/['wq']/['w']" in names
    assert j["leaves"][0]["name"].startswith(".params/")


# --------------------------------------------------------------------------
# K4's backward: the plain version and the autograd Function
# --------------------------------------------------------------------------

# (B, S, H, KvH, D, block): GQA of llama3.2-1b's 4:1 ratio, multi-query,
# MHA; S ragged against the blocks.
ATTN_CASES = [(2, 37, 8, 2, 16, 16), (1, 50, 4, 1, 8, 16),
              (2, 33, 3, 3, 24, 8)]


@pytest.mark.parametrize("b,s,h,kvh,d,block", ATTN_CASES)
def test_flash_plain_backward_matches_jax_grad_of_naive_attention(
        b, s, h, kvh, d, block):
    rng = np.random.default_rng(s + h)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jattn.naive_attention(q, k, v, causal=True) * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))
    out, lse = flash_plain(tq, tk, tv, causal=True, block_q=block,
                           block_k=block, return_lse=True)
    got = flash_plain_backward(tq, tk, tv, out, lse, tdo, causal=True,
                               block_q=block, block_k=block)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g.transpose(1, 2), w) <= ATTN_REL, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kvh,d,block", ATTN_CASES)
def test_attention_function_gradient_equals_autograd_through_flash_plain(
        b, s, h, kvh, d, block, causal):
    """``flash_attention`` under autograd on a CPU tensor (the Function:
    ``flash_plain`` forward with the lse kept, ``flash_plain_backward``)
    against autograd through ``flash_plain``'s own ops."""
    rng = np.random.default_rng(s * 3 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).requires_grad_()
        for shape in ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d)))
    dout = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32))
    want = torch.autograd.grad(
        flash_plain(q, k, v, causal=causal, block_q=block, block_k=block),
        (q, k, v), dout)
    out = flash_attention(q, k, v, causal=causal, block_k=s)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), dout)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w.numpy()) <= ATTN_REL, name


def test_attention_without_a_gradient_is_the_forward_alone():
    q = torch.randn(1, 2, 8, 4)
    with torch.no_grad():
        out = flash_attention(q.requires_grad_(), q, q)
    assert out.grad_fn is None
    assert torch.equal(out, flash_plain(q.detach(), q.detach(), q.detach()))


def test_flash_plain_lse_is_the_rows_logsumexp():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 29, 8)).astype(
        np.float32)) for _ in range(3))
    out, lse = flash_plain(q, k, v, causal=True, block_q=8, block_k=8,
                           return_lse=True)
    s = (q @ k.transpose(-1, -2)) / 8 ** 0.5
    s = s.masked_fill(torch.ones(29, 29, dtype=torch.bool).triu(1), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(out, flash_plain(q, k, v, causal=True, block_q=8,
                                        block_k=8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_plan_routes_every_head_dim_within_a_block(dtype):
    """The backward's route over head dims 1-256: bfloat16 on the tensor
    cores wherever TMA reads whole 16-byte rows and dK, dV fit a thread's
    registers (D % 8 == 0, D <= 128), padded to 64 or 128; float32 on
    them in three TF32 passes at D % 8 == 0 up to 64 (the hi and lo
    tiles), padded to 32 or 64; everything else on the FMA tiles.  Every
    plan's shared memory fits the 232,448 bytes a block may opt into."""
    for d in range(1, 257):
        p = flash_bwd_plan(d, dtype)
        tc = dtype == torch.bfloat16 and d % 8 == 0 and d <= 128
        tf = dtype == torch.float32 and d % 8 == 0 and d <= 64
        assert p.kernel == ("wgmma" if tc else "tf32" if tf else "fma"), d
        assert 0 < p.dq_smem <= p.dkdv_smem <= SMEM_LIMIT, d
        if tc:
            assert p.head_dim == (64 if d <= 64 else 128), d
            assert (p.block_rows, p.block_cols, p.stages) == (128, 64, 3)
        elif tf:
            assert p.head_dim == (32 if d <= 32 else 64), d
            assert (p.block_rows, p.block_cols, p.stages) == (128, 32, 1)
        else:
            assert p.head_dim == d
            assert p.block_rows == p.block_cols == (64 if d <= 128 else 32)


def test_flash_bwd_plan_shared_memory_and_refusals():
    """The tensor-core tiles' bytes: two resident 128-row tiles, three
    stages of two 64-row tiles (bf16, at the padded width), the dK / dV
    stages' lse and delta, the mbarriers (64 bytes) and the 1 KB
    alignment."""
    assert flash_bwd_plan(64, torch.bfloat16)[-2:] == (84_544, 83_008)
    assert flash_bwd_plan(128, torch.bfloat16)[-2:] == (166_464, 164_928)
    assert flash_bwd_plan(40, torch.bfloat16)[-2:] == (84_544, 83_008)
    assert flash_bwd_plan(128, torch.float32)[-2:] == (165_888, 149_248)
    for d in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            flash_bwd_plan(d, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_bwd_plan(64, torch.float16)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``--device cpu --smoke --steps 4 --ckpt-every 2``, then the step-4
    checkpoint removed and ``--resume``: it resumes at step 2 and ends on
    the straight run's step-4 state, bitwise."""
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2"]
    assert ltrain.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ")
    assert out[1] == f"checkpoint -> {d}/step_00000002"
    assert out[2].startswith("step     3 loss ") and out[-1] == "done"
    straight = str(tmp_path / "straight")
    shutil.move(os.path.join(d, "step_00000004"), straight)
    assert ltrain.main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"resumed from {d}/step_00000002 at step 2"
    _, like, _ = _fresh()
    a, sa = restore_checkpoint(straight, like)
    b, sb = restore_checkpoint(latest_checkpoint(d), like)
    assert sa == sb == 4 and _trees_equal(a, b)


def test_launcher_flags_and_defaults():
    args = ltrain.parse_args([])
    assert (args.arch, args.smoke, args.steps, args.batch, args.seq,
            args.ckpt_dir, args.ckpt_every, args.resume, args.seed,
            args.lr, args.device) == ("llama3.2-1b", False, 50, 4, 64, None,
                                      25, False, 0, 3e-4, None)


def test_launcher_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ltrain.main(["--smoke", "--steps", "1"])


def test_synthetic_batch_is_a_pure_function_of_seed_and_step():
    a = ltrain.synthetic_batch(100, 2, 8, 3, seed=1, device="cpu")
    b = ltrain.synthetic_batch(100, 2, 8, 3, seed=1, device="cpu")
    c = ltrain.synthetic_batch(100, 2, 8, 4, seed=1, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 100
