"""End-to-end trainer with checkpoint/restart, the counterpart of the JAX
package's ``repro.launch.train``.

Runs any LM arch (full or smoke config) on synthetic data.  The data is
a pure function of (seed, step), so a crash + restore resumes bit-exactly
on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3-12b --smoke --steps 50 --ckpt-dir /tmp/ckpt \\
      --ckpt-every 20                                   # on the host
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --batch 4 --seq 4096 --steps 3                    # full width, card

The flags are the JAX launcher's, with its defaults (``--smoke`` is
``store_true``: full width unless asked), plus ``--device`` (the card
unless ``cpu``; with no card and no ``--device cpu`` it raises).  The
weights are random float32 masters drawn from ``--seed`` on the device.
The only host reads are the printed metrics and the checkpoint writes.
Crash-loop semantics: the launcher re-executes this script; ``--resume``
finds the latest complete checkpoint and continues.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.device import resolve_device


def synthetic_batch(vocab: int, batch: int, seq: int, step: int,
                    seed: int = 0, device=None):
    """Deterministic batch keyed on (seed, step), replayable after a
    restart: uniform token ids from a ``torch.Generator`` seeded with
    both, labels the tokens shifted left by one (wrapping).  Its stream
    is torch's, not ``jax.random``'s: the two packages' batches differ
    (the parity tests feed both the same numpy tokens)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen, device=dev)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def build(arch: str, *, smoke: bool = False, seed: int = 0, device=None):
    """``(cfg, state)``: the config of ``arch`` and a fresh training state
    (random float32 weights from ``seed`` on ``device``, zero moments)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.train import init_train_state

    cfg = get_config(arch, smoke=smoke).model
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_train_state(init_params(gen, cfg))


def make_step(cfg, *, lr: float = 3e-4, total_steps: int = 10_000,
              accum_steps: int = 1):
    """The train step of ``cfg``'s ``loss_fn`` under ``AdamWConfig(lr=lr,
    total_steps=total_steps)``."""
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train import AdamWConfig, make_train_step

    return make_train_step(lambda p, b: loss_fn(p, cfg, b),
                           AdamWConfig(lr=lr, total_steps=total_steps),
                           accum_steps=accum_steps)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from repro_torch.train import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, state = build(args.arch, smoke=args.smoke, seed=args.seed,
                       device=dev)
    start_step = 0
    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            state, start_step = restore_checkpoint(path, state)
            print(f"resumed from {path} at step {start_step}")

    step_fn = make_step(cfg, lr=args.lr, total_steps=args.steps)
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = synthetic_batch(cfg.vocab, args.batch, args.seq, step,
                                args.seed, dev)
        state, metrics = step_fn(state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            row = torch.stack([metrics["loss"], metrics["grad_norm"],
                               metrics["lr"]])
            # One read of the three metrics, to print them.
            loss, gnorm, lr = row.tolist()  # analysis: ignore[host-sync] — the printed metrics
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {lr:.2e} [{dt:.1f}s]", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step + 1, state)
            print(f"checkpoint -> {path}")
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
