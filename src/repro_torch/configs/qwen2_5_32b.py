"""qwen2.5-32b [dense] — GQA, QKV bias.

Assigned: 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family card].
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family=DENSE,
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)
