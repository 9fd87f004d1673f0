"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

Assigned: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64 [arXiv:2411.15242]. Shared attention applied every 6 mamba
layers (weights shared across application points, per the Zamba design).
"""
from repro_torch.models.config import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family=HYBRID,
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,             # 3584 / 32
    ssm_state=64,
    ssm_head_dim=64,          # d_inner = 7168 -> 112 mamba heads
    ssm_expand=2,
    ssm_chunk=256,
    shared_attn_every=6,      # 13 applications over 81 layers + 3 trailing
    global_window_long=32768, # long-context mode window for the shared attn
    source="arXiv:2411.15242",
)
