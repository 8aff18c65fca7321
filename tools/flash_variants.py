#!/usr/bin/env python3
"""Time variants of the attention kernels (K4) side by side.

    python3 tools/flash_variants.py [--parent DIR]  # the forward, flash.cu
    python3 tools/flash_variants.py --backward      # flash_bwd.cu
    python3 tools/flash_variants.py --float32       # both, float32

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Each variant is ``src/repro_torch/csrc/flash.cu`` (or
``flash_bwd.cu``) with a few source substitutions (each must match
exactly once, in the source or in the shared ``flash_tc.cuh``, which
each variant gets a copy of), built in parallel.

Forward: the shipped kernel, its loads element by element (the fallback
for head dims that are no multiple of 8) instead of by TMA, one block
per SM at every width, two at width 128 as well as 64, and 64-key tiles
at head dim 64; with ``--parent DIR``, also the ``flash.cu`` of the
checkout at DIR as it is, with the shipped kernels' SASS compared to its
(``cuobjdump -sass``, kernel by kernel).  Each is checked against
``flash_plain`` (row-relative error, as ``chip_smoke.py`` phase 8) and
timed at phase 8's bfloat16 cases and phase 16 (a)'s grouped-query call
(CUDA events, L2 flushed, median of 5, in turns: the variants in order,
then in reverse) beside ``scaled_dot_product_attention``.

Backward (the tensor-core route): the shipped kernels, a ring of two
streamed stages, three warpgroups (192 rows) a block, the dK / dV
blocks ordered by KV head (one head's Q and dO stay in L2) instead of by
key tile, and the dK / dV kernel capped for two blocks an SM; with ``--parent DIR`` (repeatable),
also the ``flash_bwd.cu`` of each checkout at DIR as it is, named by
DIR's last part, with the shipped kernels' SASS compared to its;
each checked against ``flash_plain_backward`` at llama3.2-1b's 32:8
heads (``chip_smoke.BWD_TOL``) and timed at ``chip_smoke.BWD_FULL``
(CUDA events, L2 flushed, median of 5, in turns: the variants in order,
then in reverse) beside ``scaled_dot_product_attention``'s backward.

Float32 (the three-pass TF32 kernels): forward and backward, the
shipped kernels, the FMA tiles (the route forced off by a substitution),
tf32's hi rounded by ``cvt.rna`` instead of integer arithmetic, lo left
unrounded (the tensor cores read its top 19 bits), 64-key forward tiles
at width 32 and the backward at one block per SM at width 32; each
checked against ``flash_plain`` / ``flash_plain_backward`` (phase 8's
and ``chip_smoke.BWD_TOL``'s float32 limits) and timed at phase 19 (c)'s
two BERT4Rec shapes and phase 8's float32 case (CUDA events, L2
flushed, median of 5, in turns) beside ``scaled_dot_product_attention``
and its backward in float32.

One process on one card.  Prints the card's name and power limit first
and ``ptxas``'s registers and spills per variant.
"""
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")
VARIANTS = {
    "shipped": [],
    "element loads, no TMA": [(
        "const int tma = d % 8 == 0 && aligned;",
        "const int tma = 0 * aligned;")],
    "one block per SM": [(
        "  return dp == 64 ? 2 : 1;\n}",
        "  return 1;\n}")],
    "two blocks per SM at DP = 128": [(
        "  return dp == 64 ? 2 : 1;\n}",
        "  return dp <= 128 ? 2 : 1;\n}")],
    "BK = 64 at DP = 64": [(
        "  return dp == 64 ? 128 : 64;\n}",
        "  return 64;\n}")],
}
BWD_VARIANTS = {
    "shipped": [],
    "two stages": [(
        "constexpr int kStages = 3;     // the streamed ring",
        "constexpr int kStages = 2;     // the streamed ring")],
    "three warpgroups a block": [
        ("constexpr int kThreads = 256;  // two warpgroups",
         "constexpr int kThreads = 384;  // three warpgroups"),
        ("constexpr int kRows = 128;     // a block's own rows",
         "constexpr int kRows = 192;     // a block's own rows")],
    "dK / dV blocks by KV head": [(
        "  const int kt = (int)(blockIdx.x / bkv);  // the first tiles walk "
        "longest\n  const long long gk = blockIdx.x % bkv;   // batch * KvH + "
        "KV head\n  const int k0 = kt * kRows;",
        "  const int n_kt = (sk + kRows - 1) / kRows;\n"
        "  const int kt = (int)(blockIdx.x % n_kt);\n"
        "  const long long gk = blockIdx.x / n_kt;\n"
        "  const int k0 = kt * kRows;")],
    "dK / dV two blocks per SM": [(
        "template <int DP>\n__global__ void __launch_bounds__(kThreads, 1)\n"
        "flash_bwd_dkdv_wgmma(",
        "template <int DP>\n__global__ void __launch_bounds__(kThreads, 2)\n"
        "flash_bwd_dkdv_wgmma(")],
}


# Float32 (``--float32``): substitutions in flash.cu, flash_bwd.cu or the
# shared header.
HI_INT = "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
LO_CVT = "  lo = to_tf32(x - __uint_as_float(hi));"
F32_VARIANTS = {
    "shipped": [],
    "FMA tiles": [("return d % 8 == 0 && d <= tf32::kMaxDim;",
                   "return false && d;")],
    "hi by cvt.rna": [(HI_INT, "  hi = to_tf32(x);")],
    "lo unrounded": [(LO_CVT, "  lo = __float_as_uint(x - "
                              "__uint_as_float(hi));")],
    "64-key tiles at width 32": [("return dp == 64 ? 64 : 32;",
                                  "return dp == 128 ? 32 : 64;")],
}
F32_BWD_VARIANTS = {
    "shipped": [],
    "FMA tiles": [("if (dtype == 0 && d <= tf32::kMaxDim) return 2;", "")],
    "hi by cvt.rna": F32_VARIANTS["hi by cvt.rna"],
    "lo unrounded": F32_VARIANTS["lo unrounded"],
    "one block per SM at width 32": [("return dp == 32 ? 2 : 1;",
                                      "return 1;")],
}


def build(item, source="flash.cu", csrc=CSRC):
    from repro_torch.kernels import _nvcc

    name, subs = item
    src = open(os.path.join(csrc, source)).read()
    header = open(os.path.join(csrc, "flash_tc.cuh")).read()
    for old, new in subs:
        if src.count(old) + header.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} matches "
                             f"{src.count(old) + header.count(old)} times in "
                             f"{source} and flash_tc.cuh")
        src, header = src.replace(old, new), header.replace(old, new)
    stem = os.path.join(OUT, source.split(".")[0] + "_" + "".join(
        c if c.isalnum() else "_" for c in name))
    os.makedirs(stem, exist_ok=True)
    # The copy includes its own flash_tc.cuh, beside it.
    for text, file in ((src, source), (header, "flash_tc.cuh")):
        with open(os.path.join(stem, file), "w") as f:
            f.write(text)
    proc = subprocess.run(
        [_nvcc.find_nvcc(), *_nvcc.NVCC_FLAGS, "-o", stem + ".so",
         os.path.join(stem, source)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-4000:]}")
    return name, stem + ".so", proc.stdout + proc.stderr


def build_all(jobs, entry, argtypes):
    """``build(*job)`` for every job, in parallel; each library loaded
    with ``entry``'s argument types, and its tensor-core kernels'
    registers and spills printed.  Returns ``{name: (library, path)}``."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: build(*job), jobs))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name, path, log in built:
        lib = ctypes.CDLL(path)
        getattr(lib, entry).argtypes = argtypes
        libs[name] = lib, path
        for kernel, regs, st, ld, _ in cs.ptxas_summary(log):
            if "wgmma" in kernel or "tf32" in kernel:
                print(f"  {name}: {kernel}: {regs} registers, spills {st} B "
                      f"stored / {ld} B loaded")
    return libs


def in_turns(calls, flush):
    """Each call timed (median of 5) with the calls in order, then in
    reverse: ``"name first / second | ..."``."""
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(cs.time_cuda(calls[name], flush, n_timed=5,
                                            n_warm=1))
    return " | ".join(f"{name} {t[0]:.4f} / {t[1]:.4f}"
                      for name, t in times.items())


def parents():
    """The checkouts named by ``--parent DIR`` options, in order."""
    argv = sys.argv[1:]
    return [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == "--parent"]


def compare_sass(mine, theirs, source):
    """Prints which kernels of two builds of ``source`` have the same
    SASS, and the first differing lines of the others."""
    mine, theirs = sass(mine), sass(theirs)
    same = [k for k in mine if theirs.get(k) == mine[k]]
    differ = sorted(set(mine) ^ set(theirs) | {
        k for k in mine if k in theirs and theirs[k] != mine[k]})
    print(f"SASS against the parent's {source}: {len(same)} kernels "
          f"identical, {len(differ)} differ or are missing: {differ}")
    for k in differ:
        a = mine.get(k, "").splitlines()
        b = theirs.get(k, "").splitlines()
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        print(f"  {k[:60]}: {len(a)} / {len(b)} lines, {len(diff)} "
              "differ; first: " + " || ".join(
                  f"{x.strip()} <> {y.strip()}" for x, y in diff[:2]))


def sass(path):
    """``{kernel: SASS}`` of a library (``cuobjdump -sass``), names with
    the unnamed namespace's per-file tag removed."""
    import re

    from repro_torch.kernels import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                  "_ZN_GLOBAL__N_", text)
    out = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = body
    return out


# Phase 8's bfloat16 cases, then phase 16 (a)'s grouped-query call at the
# llama3.2-1b prefill's shape: (label, causal, B, H, KvH, S, D).
FORWARD_CASES = tuple(
    (label, causal, b, h, h, s, d)
    for label, dtype_name, causal, b, h, s, d in cs.FLASH_CASES
    if dtype_name == "bfloat16") + (
    ("llama3.2-1b GQA prefill", True, cs.LM_BATCH, 32, 8, cs.LM_PROMPT, 64),)


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash_plain

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    os.makedirs(OUT, exist_ok=True)
    if "--backward" in sys.argv[1:]:
        return backward()
    if "--float32" in sys.argv[1:]:
        return float32()
    jobs = [(item, "flash.cu") for item in VARIANTS.items()]
    jobs += [(("parent", []), "flash.cu", os.path.join(
        parent, "src", "repro_torch", "csrc")) for parent in parents()[:1]]
    libs = build_all(jobs, "flash_launch", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    if "parent" in libs:
        compare_sass(libs["shipped"][1], libs["parent"][1], "flash.cu")

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    for label, causal, b, h, kvh, s, d in FORWARD_CASES:
        q = torch.randn(b, h, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(b, kvh, s, d, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        want = flash_plain(q, k, v, causal=causal, block_q=4096,
                           block_k=4096)
        out = torch.empty_like(q)
        calls = {}
        for name, (lib, _) in libs.items():
            def call(lib=lib, name=name):
                rc = lib.flash_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, b * h, h, kvh, s, s, d, 1.0 / d ** 0.5,
                    int(causal), 1, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{name}: launch failed: error {rc}")
            call()
            rel = cs.row_rel_err(out, want)
            if rel > cs.FLASH_ROW_REL["bfloat16"]:
                raise SystemExit(f"{name}, {label}: row-relative error {rel}")
            calls[name] = call
        turns = in_turns(calls, flush)
        sdpa = cs.time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=kvh != h), flush,
            n_timed=5, n_warm=1)
        print(f"{label} (H={h} KvH={kvh} S={s} D={d}, ms, in turns): "
              f"{turns} | sdpa {sdpa:.4f}", flush=True)
        del q, k, v, want, out
    return 0


def backward() -> int:
    """The backward's variants (see the module docstring)."""
    import torch

    from repro_torch.kernels.flash import flash_cuda, flash_plain_backward

    jobs = [(item, "flash_bwd.cu") for item in BWD_VARIANTS.items()]
    jobs += [((os.path.basename(os.path.normpath(parent)), []),
              "flash_bwd.cu", os.path.join(parent, "src", "repro_torch",
                                           "csrc"))
             for parent in parents()]
    libs = build_all(jobs, "flash_bwd_launch", [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    for parent in parents():
        compare_sass(libs["shipped"][1],
                     libs[os.path.basename(os.path.normpath(parent))][1],
                     "flash_bwd.cu")

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)

    def inputs(b, h, kvh, s, d):
        q = (torch.randn(b, h, s, d, generator=gen, device=dev) * 0.3).to(
            torch.bfloat16)
        k = (torch.randn(b, kvh, s, d, generator=gen, device=dev) * 0.3).to(
            torch.bfloat16)
        v = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
        out, lse = flash_cuda(q, k, v, causal=True, return_lse=True)
        dout = torch.randn(b, h, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
        return q, k, v, out, lse, dout

    def caller(lib, args):
        q, k, v, out, lse, dout = args
        b, h, s, d = q.shape
        grads = [torch.empty_like(x) for x in (q, k, v)]
        delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)

        def call():
            rc = lib.flash_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                *(g.data_ptr() for g in grads), b * h, h, k.shape[1], s, s,
                d, 1.0 / d ** 0.5, 1, 1,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: error {rc}")
            return grads
        return call

    for d in (64, 128):
        args = inputs(1, 32, 8, 390, d)
        want = flash_plain_backward(*args, causal=True)
        for name, (lib, _) in libs.items():
            got = caller(lib, args)()
            errs = [cs.rel_max(g, w) for g, w in zip(got, want)]
            if max(errs) > cs.BWD_TOL["bfloat16"]:
                raise SystemExit(f"{name} D={d}: dQ, dK, dV {errs}")
        print(f"D={d} S=390 H:KvH=32:8: every variant within "
              f"{cs.BWD_TOL['bfloat16']} of the plain backward")

    b, h, kvh, s, d = cs.BWD_FULL
    args = inputs(b, h, kvh, s, d)
    turns = in_turns({name: caller(lib, args)
                      for name, (lib, _) in libs.items()}, flush)
    q, k, v, _, _, dout = args
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True)
    sdpa = cs.time_cuda(lambda: torch.autograd.grad(
        o, (qs, ks, vs), dout, retain_graph=True), flush, n_timed=5,
        n_warm=1)
    print(f"backward B={b} H={h} KvH={kvh} S={s} D={d}, ms (in turns): "
          f"{turns} | sdpa enable_gqa backward {sdpa:.4f}")
    return 0


# --float32's shapes: phase 19 (c)'s two (BERT4Rec's attention at
# serve_p99's 512 sequences and at the training batch of 8,192) and
# phase 8's float32 case: (label, causal, B, H, S, D).
F32_CASES = (("bert4rec p99", False, 512, 2, 200, 32),
             ("bert4rec train", False, 8192, 2, 200, 32)) + tuple(
    (label, causal, b, h, s, d)
    for label, dtype_name, causal, b, h, s, d in cs.FLASH_CASES
    if dtype_name == "float32")


def float32() -> int:
    """The float32 kernels' variants (see the module docstring)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash_plain, flash_plain_backward

    fwd = build_all([(item, "flash.cu") for item in F32_VARIANTS.items()],
                    "flash_launch", [ctypes.c_void_p] * 5 + [
                        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p])
    bwd = build_all([(item, "flash_bwd.cu")
                     for item in F32_BWD_VARIANTS.items()],
                    "flash_bwd_launch", [ctypes.c_void_p] * 10 + [
                        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p])
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(33)
    rtol, atol = cs.FLASH_TOL["float32"]
    for label, causal, b, h, s, d in F32_CASES:
        q = torch.randn(b, h, s, d, generator=gen, device=dev) * 0.3
        k = torch.randn(b, h, s, d, generator=gen, device=dev) * 0.3
        v = torch.randn(b, h, s, d, generator=gen, device=dev)
        dout = torch.randn(b, h, s, d, generator=gen, device=dev)
        out, lse = flash_plain(q, k, v, causal=causal, return_lse=True,
                               block_q=1024, block_k=1024)
        want = flash_plain_backward(q, k, v, out, lse, dout, causal=causal,
                                    block_q=1024, block_k=1024)
        stream = torch.cuda.current_stream().cuda_stream
        o = torch.empty_like(q)
        calls = {}
        for name, (lib, _) in fwd.items():
            def call(lib=lib, name=name):
                rc = lib.flash_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, b * h, h, h, s, s, d, 1.0 / d ** 0.5, int(causal),
                    0, stream)
                if rc:
                    raise SystemExit(f"{name}: launch failed: error {rc}")
            call()
            torch.cuda.synchronize()
            err = (o - out).abs() - (atol + rtol * out.abs())
            rel = cs.row_rel_err(o, out)
            if err.max().item() > 0 or rel > cs.FLASH_ROW_REL["float32"]:
                raise SystemExit(f"{name}, {label}: forward outside rtol "
                                 f"{rtol} atol {atol} or row-relative {rel}")
            calls[name] = call
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal)
        print(f"{label} forward (B={b} H={h} S={s} D={d}, "
              f"{'causal' if causal else 'bidirectional'}, ms, in turns): "
              f"{in_turns(calls, flush)}", flush=True)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        delta = torch.empty(lse.shape, dtype=torch.float32, device=dev)
        calls = {}
        for name, (lib, _) in bwd.items():
            def call(lib=lib, name=name):
                rc = lib.flash_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    *(g.data_ptr() for g in grads), b * h, h, h, s, s, d,
                    1.0 / d ** 0.5, int(causal), 0, stream)
                if rc:
                    raise SystemExit(f"{name}: launch failed: error {rc}")
            call()
            torch.cuda.synchronize()
            errs = [cs.rel_max(g, w) for g, w in zip(grads, want)]
            if max(errs) > cs.BWD_TOL["float32"]:
                raise SystemExit(f"{name}, {label}: dQ, dK, dV {errs}")
            calls[name] = call
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        calls["sdpa backward"] = lambda: torch.autograd.grad(
            so, (qs, ks, vs), dout, retain_graph=True)
        print(f"{label} backward (ms, in turns): {in_turns(calls, flush)}",
              flush=True)
        del q, k, v, dout, out, lse, want, o, grads, delta, qs, ks, vs, so
        calls = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
