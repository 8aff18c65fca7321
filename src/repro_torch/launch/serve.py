"""Batched LM serving launcher: prefill a prompt batch, then decode N tokens
greedily, the counterpart of the JAX package's ``repro.launch.serve``.

Naming note: this is the *LM decode* entry point (transformer stack).
Hypergraph query serving, the coalescing front-end over
``Engine.compile``, lives in ``repro_torch.launch.serve_hypergraph``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --no-smoke --batch 4 --prompt-len 4096 --gen 16       # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch gemma3-12b --batch 4 --prompt-len 32 --gen 16  # smoke config

The weights are random, drawn from ``--seed`` on the device, and the
prompts from seed 1.  ``--smoke`` (the default) takes the reduced
config; ``--no-smoke`` takes the published one (the JAX package's flag
is ``store_true`` with ``default=True``, so its full width cannot be
reached).  The prefill's bfloat16 cache moves into a cache of the full
length (prompt + ``--gen``), and decode writes one position a step.
Prints the prefill's and the decode's wall time (through a
synchronize) and the generated ids of the first sequence.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.device import resolve_device


def build(arch: str, *, smoke: bool = True, seed: int = 0, device=None):
    """``(cfg, params)``: the config of ``arch`` and random weights from
    ``seed`` on ``device`` (the card unless ``"cpu"``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch, smoke=smoke).model
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(gen, cfg)


def make_prompts(cfg, batch: int, prompt_len: int,
                 device=None) -> torch.Tensor:
    """``[batch, prompt_len]`` token ids, uniform over the vocab, from
    seed 1 (the JAX launcher's prompt key)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        # The timer reads a finished run.
        torch.cuda.synchronize(dev)  # analysis: ignore[host-sync] — the wall clock's read, once a phase


def generate(params, cfg, prompts: torch.Tensor, gen: int):
    """Prefill ``prompts`` and decode greedily: returns ``(ids [B, gen],
    {"prefill_s", "decode_s", "steps"})``.  The first id comes from the
    prefill's logits, each next one from a ``serve_step``."""
    from repro_torch.models.transformer import init_cache, prefill, serve_step

    dev = prompts.device
    b, s = prompts.shape
    t0 = time.perf_counter()
    logits, warm = prefill(params, cfg, prompts)
    cache = init_cache(cfg, b, s + gen, dtype=warm["k"].dtype, device=dev)
    for key in cache:
        cache[key][:, :, :s].copy_(warm[key])
    del warm
    tok = torch.argmax(logits, dim=-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = serve_step(params, cfg, cache, tok, s + i)
        tok = torch.argmax(logits, dim=-1)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.stack(generated, dim=1), {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "steps": max(gen - 1, 0)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, params = build(args.arch, smoke=args.smoke, seed=args.seed,
                        device=args.device)
    prompts = make_prompts(cfg, args.batch, args.prompt_len,
                           device=args.device)
    with torch.no_grad():
        out, t = generate(params, cfg, prompts, args.gen)
    steps = t["steps"]
    print(f"prefill: {t['prefill_s'] * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len} tokens")
    print(f"decode:  {t['decode_s'] * 1e3:.1f} ms for {steps} steps "
          f"({t['decode_s'] / max(steps, 1) * 1e3:.2f} ms/step)")
    # One read of the ids, after the timed run.
    ids = out[0].tolist()  # analysis: ignore[host-sync] — the printed result
    print(f"generated ids [batch 0]: {ids}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
