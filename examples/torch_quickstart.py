"""Quickstart on the PyTorch port: build any assigned architecture, generate
a few tokens, and predict its serving latency with the OOCO roofline perf
model. The port of ``examples/quickstart.py``; runs on a CUDA card (prefill
attention through the flash kernel) unless given ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--arch qwen3-8b] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.perf_model import PerfModel
from repro_torch.kernels import require_device
from repro_torch.models.model import build_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ASSIGNED)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    dev = require_device(args.device)

    full = get_config(args.arch)
    cfg = full.reduced()  # small variant of the same family
    print(f"arch={full.name} [{full.family}]  full: {full.num_layers}L "
          f"d={full.d_model} (~{full.num_params()/1e9:.1f}B params) "
          f"| running reduced: {cfg.num_layers}L d={cfg.d_model}")

    model = build_model(cfg, remat=False)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.RandomState(0)
    prompt = list(rng.randint(0, cfg.vocab_size, 16))
    batch = {"tokens": torch.tensor([prompt], dtype=torch.int32, device=dev)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn(
            (1, cfg.num_frontend_tokens, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1)).to(torch.bfloat16)
    if cfg.family == "audio":
        batch["frontend_embeds"] = torch.randn(
            (1, 64, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1)).to(torch.bfloat16)

    cache_len = len(prompt) + args.tokens + cfg.num_frontend_tokens
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    out = [int(logits.argmax(-1)[0])]
    for _ in range(args.tokens - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([out[-1]], dtype=torch.int32, device=dev), cache)
        out.append(int(logits.argmax(-1)[0]))
    print("generated token ids:", out)

    # perf-model view of the FULL-SIZE model on an H100 (data-sheet rates)
    pm = PerfModel(full, H100_SXM, tp=4)
    p = pm.prefill_estimate([1024])
    d = pm.decode_estimate([1024] * 64)
    print(f"h100(tp=4) predictions: prefill(1024)={p.latency*1e3:.1f}ms "
          f"[{p.bottleneck}]  decode(B=64,ctx=1024)={d.latency*1e3:.1f}ms "
          f"[{d.bottleneck}]  bs_sat={pm.compute_saturated_batch(1024)}")


if __name__ == "__main__":
    main()
