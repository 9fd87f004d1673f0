"""Random weights for a dense decoder, made from the seed on the device in a
few large calls, in the dtype the configuration serves them in, and laid
out as the port's ``Transformer`` takes them (layers stacked on axis 0,
``dense`` weights (d_in, d_out), an RMSNorm weight stored as its offset from
1). The benchmark hands the same tensors to the program and to the plain
reference."""
from __future__ import annotations

import math

import torch


def dims(config: dict) -> dict:
    """The sizes the layout and the counts need, from a configuration file."""
    d = config["hidden_size"]
    hq = config["num_attention_heads"]
    return {"L": config["num_hidden_layers"], "d": d, "Hq": hq,
            "Hkv": config["num_key_value_heads"], "hd": d // hq,
            "ff": config["intermediate_size"], "V": config["vocab_size"]}


def make_weights(config: dict, seed: int, device) -> dict:
    """The parameter tree, drawn from a generator on ``device`` seeded with
    ``seed``, at the standard deviations the configuration's ``weights``
    give."""
    s = config["weights"]
    n = dims(config)
    L, d, hq, hkv, hd, ff, V = (n[k] for k in ("L", "d", "Hq", "Hkv", "hd", "ff", "V"))
    dt = getattr(torch, config["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=dt).mul_(std)

    def dense(d_in, d_out, std, bias_std=None):
        p = {"w": normal((L, d_in, d_out), std)}
        if bias_std is not None:
            p["b"] = normal((L, d_out), bias_std)
        return p

    bias = s["qkv_bias"] if config["qkv_bias"] else None
    return {
        "embed": normal((V, d), s["embed"]),
        "layers": {
            "ln1": {"scale": normal((L, d), s["norm_offset"])},
            "attn": {
                "wq": dense(d, hq * hd, s["qkv"], bias),
                "wk": dense(d, hkv * hd, s["qkv"], bias),
                "wv": dense(d, hkv * hd, s["qkv"], bias),
                "wo": dense(hq * hd, d, s["o_per_sqrt_2L"] / math.sqrt(2 * L)),
            },
            "ln2": {"scale": normal((L, d), s["norm_offset"])},
            "mlp": {
                "gate": dense(d, ff, s["gate_up"]),
                "up": dense(d, ff, s["gate_up"]),
                "down": dense(ff, d, s["down_per_sqrt_2"] / math.sqrt(2)),
            },
        },
        "final_norm": {"scale": normal((d,), s["norm_offset"])},
        "lm_head": normal((d, V), s["lm_head"]),
    }


def weight_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
