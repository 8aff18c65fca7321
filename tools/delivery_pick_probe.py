#!/usr/bin/env python3
"""How well one timing of a delivery pair predicts another, on one card.

    python3 tools/delivery_pick_probe.py [--rounds 8] [--scales 0.002 0.01 0.05]

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  At each DBLP scale, with 64 float32 columns (256-byte rows,
where ``select_delivery`` measures its pick), it repeats ``--rounds``
times the order of ``chip_smoke.py``'s phase 10 grid point: a checked
pair, the check's timing (``time_in_turns``, 3 warm calls, 20 turns, on
random messages), 20 pairs queued back to back on each lowering, then
the pick's timing (``measure_delivery_pair``, the Engine's constant
messages), and a second check-style timing after it.  The pick's
timing is also taken before the queued pairs, and with the check's
warm calls and turns.  For each timing it prints the median ms of
``xla`` and of the fused K1 leaf, and their ratio; at the end, for each
way of timing the pick, in how many rounds it named the path that the
check's timing found faster by more than 10%.  Prints the card's name
and power limit first.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch

    from repro_torch.core import Engine, Program, deliver
    from repro_torch.core.api import constant_initial_msg
    from repro_torch.core.executor import time_in_turns
    from repro_torch.data import make_dataset

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--scales", type=float, nargs="+",
                    default=[0.002, 0.01, 0.05])
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    prog = Program(procedure=None, combiner="sum")
    gen = torch.Generator(device=dev).manual_seed(11)
    d = 64
    ways = ("pick_before_loop", "pick", "pick_20_turns", "check_again")
    agree = {w: [0, 0] for w in ways}
    for scale in args.scales:
        hg = make_dataset("dblp", scale, seed=0, device=dev)
        fwd, bwd = Engine(device=dev)._delivery_layouts(hg)
        nv, ne = hg.n_vertices, hg.n_hyperedges
        rand = (torch.rand((nv, d), generator=gen, device=dev),
                torch.rand((ne, d), generator=gen, device=dev))
        const = tuple(constant_initial_msg(torch.zeros(d), n, device=dev)
                      .contiguous() for n in (nv, ne))

        def pair(msgs, fused, mask=False):
            deliver(msgs[0], None, hg.src, hg.dst, ne, prog,
                    hg.e_attr, hg.e_mask if mask else None,
                    layout=fwd if fused else None)
            deliver(msgs[1], None, hg.dst, hg.src, nv, prog,
                    hg.e_attr, hg.e_mask if mask else None,
                    layout=bwd if fused else None)

        def timed(msgs, turns, warm, mask=False):
            return time_in_turns(lambda: pair(msgs, False, mask),
                                 lambda: pair(msgs, True, mask), dev,
                                 flush=flush, turns=turns, warm=warm)

        print(f"scale {scale}: nnz {hg.nnz}, D = {d}, e_mask "
              f"{'set' if hg.e_mask is not None else 'None'}; "
              "xla_ms fused_ms xla/fused")
        for r in range(args.rounds):
            pair(rand, True)
            pair(rand, False)
            torch.cuda.synchronize()
            got = {"check": timed(rand, 20, 3)}
            got["pick_before_loop"] = timed(const, 5, 1, mask=True)
            for fused in (False, True):
                for _ in range(20):
                    pair(rand, fused)
            torch.cuda.synchronize()
            got["pick"] = timed(const, 5, 1, mask=True)
            got["pick_20_turns"] = timed(const, 20, 3, mask=True)
            got["check_again"] = timed(rand, 20, 3)
            x, f = got["check"]
            faster = "fused" if f < x else "xla"
            clear = abs(x - f) / min(x, f) > 0.10
            line = []
            for w, (xw, fw) in got.items():
                line.append(f"{w} {xw:.4f} {fw:.4f} {xw / fw:.3f}")
                if w in agree and clear:
                    agree[w][1] += 1
                    agree[w][0] += ("fused" if fw < xw else "xla") == faster
            print(f"  round {r}: " + " | ".join(line), flush=True)
    for w, (ok, n) in agree.items():
        print(f"{w}: named the check's clearly faster path in {ok} of {n} "
              "rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
