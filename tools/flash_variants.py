#!/usr/bin/env python3
"""Time variants of the bfloat16 attention kernel (K4) side by side.

    python3 tools/flash_variants.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Each variant is ``src/repro_torch/csrc/flash.cu`` with a few
source substitutions (each must match exactly once): the shipped
kernel, its loads element by element (the fallback for head dims that
are no multiple of 8) instead of by TMA, one block per SM at every
width, two at width 128 as well as 64, and 64-key tiles at head dim 64.
All are built in parallel, checked against ``flash_plain``
(row-relative error, as ``chip_smoke.py`` phase 8) and timed at phase
8's bfloat16 cases (CUDA events, L2 flushed, median of 5) beside
``scaled_dot_product_attention``, in one process on one card.  Prints the card's name and power limit
first and ``ptxas``'s registers and spills per variant.
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

SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "flash.cu")
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


def build(item):
    from repro_torch.kernels import _nvcc

    name, subs = item
    src = open(SOURCE).read()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} matches {src.count(old)} "
                             "times in flash.cu")
        src = src.replace(old, new)
    stem = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                     for c in name))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.run(
        [_nvcc.find_nvcc(), *_nvcc.NVCC_FLAGS, "-o", stem + ".so",
         stem + ".cu"], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-4000:]}")
    return name, stem + ".so", proc.stdout + proc.stderr


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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS.items()))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name, path, log in built:
        lib = ctypes.CDLL(path)
        lib.flash_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
        libs[name] = lib
        for kernel, regs, st, ld, _ in cs.ptxas_summary(log):
            if "wgmma" in kernel:
                print(f"  {name}: {kernel}: {regs} registers, spills {st} B "
                      f"stored / {ld} B loaded")

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    for label, dtype_name, causal, b, h, s, d in cs.FLASH_CASES:
        if dtype_name != "bfloat16":
            continue
        qkv = [torch.randn(b, h, s, d, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3)]
        want = flash_plain(*qkv, causal=causal, block_q=4096, block_k=4096)
        out = torch.empty_like(qkv[0])
        cells = []
        for name, lib in libs.items():
            def call(lib=lib):
                rc = lib.flash_launch(
                    *(x.data_ptr() for x in qkv), out.data_ptr(), None,
                    b * h, h, h, s, s, d, 1.0 / d ** 0.5, int(causal), 1,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"{name}: launch failed: error {rc}")
            call()
            rel = cs.row_rel_err(out, want)
            if rel > cs.FLASH_ROW_REL["bfloat16"]:
                raise SystemExit(f"{name}, {label}: row-relative error {rel}")
            ms = cs.time_cuda(call, flush, n_timed=5, n_warm=1)
            cells.append(f"{name} {ms:.4f}")
        sdpa = cs.time_cuda(lambda: F.scaled_dot_product_attention(
            *qkv, is_causal=causal), flush, n_timed=5, n_warm=1)
        print(f"{label} (H={h} S={s} D={d}, ms): " + " | ".join(cells)
              + f" | sdpa {sdpa:.4f}", flush=True)
        del qkv, want, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
