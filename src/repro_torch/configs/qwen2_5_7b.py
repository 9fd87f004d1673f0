"""qwen2.5-7b — the paper's primary evaluation model (§5.1.2).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias
[arXiv:2407.10671].
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    family=DENSE,
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671 / paper §5.1.2",
)
