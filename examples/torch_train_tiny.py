"""Train a ~100M-param model for a few hundred steps on the synthetic corpus
with the PyTorch port (end-to-end training for the train_4k workload
shape's path), on a CUDA card unless given ``--device cpu``. The port of
``examples/train_tiny.py``; the checkpoint goes to the temp dir by default.

  PYTHONPATH=src python examples/torch_train_tiny.py --steps 300
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import require_device
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint
from repro_torch.training.data_pipeline import DataConfig, packed_batches
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_tiny.npz"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = require_device(args.device)

    cfg = get_config(args.arch).reduced(
        layers=args.layers, d_model=args.d_model, vocab=4096, d_ff=1024)
    print(f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"~{cfg.num_params()/1e6:.0f}M params, seq={args.seq} "
          f"batch={args.batch}")
    model = build_model(cfg, remat=True)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    batch_size=args.batch)
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=args.steps // 10,
                          total_steps=args.steps)
    params, opt_state, hist = train(
        model, params, packed_batches(dc, args.steps), opt_cfg,
        log_every=max(args.steps // 15, 1))
    checkpoint.save(args.ckpt, params, opt_state, args.steps)
    first, last = hist[0][1], hist[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({(first - last) / first:.0%} reduction); checkpoint: {args.ckpt}")


if __name__ == "__main__":
    main()
