"""qwen3-8b [dense] — qk_norm, GQA.

Assigned: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
[hf:Qwen/Qwen3-8B].
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family=DENSE,
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)
