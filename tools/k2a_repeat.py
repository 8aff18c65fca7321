#!/usr/bin/env python3
"""K2a's worst error over repeated calls, on one card.

    python3 tools/k2a_repeat.py [--calls 200]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Makes the inputs of ``tests/test_torch_cuda.py::
test_cuda_segsum_kernels_equal_plain[dtype0-1000]`` (float32, D = 1000,
E = 50,000 messages into N = 3,000 rows, seed 1000: a row of 2,000
edges at 17, heavy rows at 130, 131, 1500, 2950 and 2999, ids outside
[0, N) dropped) and runs them through K2a (``segment_sum_mxu``,
``block_e=300``) ``--calls`` times in the test's order and as many in
its shuffled order.  K2a's combine order varies between calls, so its
float sums move by roundings.  For each order it prints, over all
calls: the worst absolute error against the plain version, the worst
share of the test's tolerance (``_segsum_tol``: ``|got - plain| /
(atol + rtol |plain|)``, above 1 fails the test) with its row, column
and the row's edge count, the calls and elements above the tolerance,
and the same errors of K2a and of the plain version against a float64
sum (which of the two strays).  Prints the card's name and power limit
first.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels.segsum import segment_sum_mxu, segsum_plain

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    card = torch.device("cuda")
    d, e, n = 1000, 50000, 3000
    rng = np.random.default_rng(d)                  # the test's inputs
    msgs = torch.as_tensor(rng.standard_normal((e, d)).astype(np.float32),
                           device=card)
    dst = rng.integers(-5, n + 5, e).astype(np.int32)
    dst[:2000] = 17
    dst[2000:8000] = rng.choice([130, 131, 1500, 2950, 2999], 6000)
    ids = torch.as_tensor(dst, device=card)
    perm = torch.as_tensor(rng.permutation(e), device=card)
    tol = 1e-5                                      # _segsum_tol, float32
    atol = tol * 10 * max(1.0, (e / n) ** 0.5 / 3.0)
    keep = (ids >= 0) & (ids < n)
    edges = torch.bincount(ids[keep].long(), minlength=n)

    for order, (m, i) in (("test order", (msgs, ids)),
                          ("shuffled", (msgs[perm].contiguous(),
                                        ids[perm].contiguous()))):
        plain = segsum_plain(m, i, n).float()
        exact = torch.zeros(n, d, dtype=torch.float64, device=card)
        k = (i >= 0) & (i < n)
        exact.index_add_(0, i[k].long(), m[k].double())
        allowed = atol + tol * plain.abs()
        worst_abs = worst_share = 0.0
        worst_at = None
        calls_over = elems_over = 0
        k2a_vs_exact = 0.0
        for _ in range(args.calls):
            got = segment_sum_mxu(m, i, n, block_e=300).float()
            err = (got - plain).abs()
            share = err / allowed
            s = float(share.max())
            over = int((share > 1).sum())
            calls_over += over > 0
            elems_over += over
            worst_abs = max(worst_abs, float(err.max()))
            k2a_vs_exact = max(k2a_vs_exact,
                               float((got.double() - exact).abs().max()))
            if s > worst_share:
                worst_share = s
                r, c = divmod(int(share.argmax()), d)
                worst_at = (r, c, int(edges[r]), float(err[r, c]),
                            float(allowed[r, c]))
        plain_vs_exact = float((plain.double() - exact).abs().max())
        r, c, nr, err_rc, allow_rc = worst_at
        print(f"{order}, {args.calls} calls: worst |K2a - plain| "
              f"{worst_abs:.3g}; worst share of the tolerance "
              f"{worst_share:.3f} at row {r} ({nr} edges), column {c} "
              f"({err_rc:.3g} against {allow_rc:.3g} allowed); "
              f"{calls_over} calls and {elems_over} elements over it; "
              f"worst |K2a - float64| {k2a_vs_exact:.3g}, "
              f"|plain - float64| {plain_vs_exact:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
