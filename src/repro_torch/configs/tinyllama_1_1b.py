"""tinyllama-1.1b [dense] — llama2-architecture small model.

Assigned: 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000
[arXiv:2401.02385].
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family=DENSE,
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    source="arXiv:2401.02385",
)
