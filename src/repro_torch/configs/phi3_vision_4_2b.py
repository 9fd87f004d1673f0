"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

Assigned: 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]. The vision encoder + projector is
a stub per the assignment: input_specs() provides patch embeddings (B,T,d).
"""
from repro_torch.models.config import VLM, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family=VLM,
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    frontend="vision",
    num_frontend_tokens=1024,  # image patch tokens prepended to the prompt
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
