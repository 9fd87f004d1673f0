"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

Assigned: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8e top-2, SWA [arXiv:2401.04088]. SWA window 4096 per the assignment;
the bounded KV cache makes long_500k runnable (DESIGN §4).
"""
from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family=MOE,
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
