"""granite-moe-3b-a800m [moe] — 40 experts, top-8.

Assigned: 32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert)
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
Note: the assignment's structured field says 40 experts (prose says 32);
we take the structured field (DESIGN §4).
"""
from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family=MOE,
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
