"""whisper-tiny [audio] — encoder-decoder, conv frontend stubbed.

Assigned: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356].
4 encoder + 4 decoder layers (whisper-tiny). The mel+conv frontend is a stub:
input_specs() provides frame embeddings. Decode-32k is architecturally
synthetic (real whisper caps at 448 positions) but lowers per the assignment;
long_500k is skipped (DESIGN §4).
"""
from repro_torch.models.config import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family=AUDIO,
    num_layers=4,           # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    attn_bias=True,
    mlp_act="gelu_mlp",
    frontend="audio",
    num_frontend_tokens=1500,  # 30 s of audio at 50 frames/s
    tie_embeddings=True,
    norm_eps=1e-5,
    source="arXiv:2212.04356",
)
