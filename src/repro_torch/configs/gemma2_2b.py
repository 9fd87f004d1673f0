"""gemma2-2b [dense] — local/global alternating attention, logit softcaps.

Assigned: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
[arXiv:2408.00118]. head_dim=256, sliding window 4096 on even (local)
layers, attn softcap 50, final softcap 30, GeGLU, sandwich norms, embedding
scaling. Long-context mode windows the global layers at 32768 (documented
deviation, DESIGN §4/§8) to make long_500k sub-quadratic.
"""
from repro_torch.models.config import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family=DENSE,
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    sliding_window=4096,
    local_global=True,
    global_window_long=32768,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    mlp_act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
