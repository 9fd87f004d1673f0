"""qwen2.5-72b — the paper's large evaluation model (§5.1.2).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, QKV bias
[arXiv:2407.10671].
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-72b",
    family=DENSE,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671 / paper §5.1.2",
)
