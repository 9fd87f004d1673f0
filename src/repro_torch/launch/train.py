"""Training launcher: run a reduced-config model (or, with ``--full-size``,
the full assigned config) for N steps on one device.

Runs on the CUDA card by default (``--device cuda``, no fallback when none
is present); ``--device cpu`` runs on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --seq 128 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --layers 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import require_device
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.data_pipeline import DataConfig, packed_batches
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def with_frames(batches, cfg, seed: int):
    """An encoder-decoder's batches with seeded frame embeddings (B,
    num_frontend_tokens, d_model) beside the tokens: the audio frontend is a
    stub, and the token pipeline makes no frames (the reference's launcher
    stops at the missing ``frontend_embeds`` for whisper)."""
    rng = np.random.default_rng(seed)
    for b in batches:
        frames = rng.standard_normal((b["tokens"].shape[0], cfg.num_frontend_tokens,
                                      cfg.d_model)).astype(np.float32)
        yield {**b, "frontend_embeds": frames}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full assigned config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda = the card (no fallback when none is present), "
                         "cpu = the CPU")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced(layers=args.layers, d_model=args.d_model, vocab=2048)
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} (~{cfg.num_params()/1e6:.1f}M params) on {device}")
    model = build_model(cfg, remat=True)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch, seed=args.seed)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    ckpt_fn = None
    if args.ckpt:
        ckpt_fn = lambda p, o, s: checkpoint.save(args.ckpt, p, o, s)
    batches = packed_batches(dc, args.steps)
    if cfg.frontend == "audio":
        batches = with_frames(batches, cfg, args.seed)
    params, opt_state, hist = train(model, params, batches,
                                    opt, checkpoint_fn=ckpt_fn,
                                    checkpoint_every=max(args.steps // 2, 1))
    if args.ckpt:
        checkpoint.save(args.ckpt, params, opt_state, args.steps)
        print(f"saved {args.ckpt}")
    first, last = hist[0][1], hist[-1][1]
    print(f"loss {first:.3f} -> {last:.3f} ({(first-last)/first:.0%} reduction)")


if __name__ == "__main__":
    main()
