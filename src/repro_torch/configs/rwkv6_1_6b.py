"""rwkv6-1.6b [ssm] — "Finch", attention-free, data-dependent decay.

Assigned: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
[arXiv:2404.05892]. 32 heads x head_dim 64. Decode state is O(1) in
sequence length, so the arch runs long_500k.
"""
from repro_torch.models.config import SSM, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family=SSM,
    num_layers=24,
    d_model=2048,
    num_heads=32,          # = rwkv_heads (d_model / rwkv_head_dim)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv=True,
    rwkv_head_dim=64,
    rwkv_lora_dim=64,
    source="arXiv:2404.05892",
)
