"""Model configuration system.

Every architecture in the zoo is *data*: a single frozen dataclass that the
generic model builders consume. One config module per assigned architecture
lives in ``repro/configs/``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Families
DENSE = "dense"
MOE = "moe"
SSM = "ssm"  # rwkv6
HYBRID = "hybrid"  # zamba2: mamba2 + shared attention
VLM = "vlm"
AUDIO = "audio"  # whisper enc-dec

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters. Only fields relevant to the family are used."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention variants ---
    attn_bias: bool = False           # qwen2.5: bias on QKV projections
    qk_norm: bool = False             # qwen3: per-head RMSNorm on q and k
    attn_logit_softcap: float = 0.0   # gemma2: tanh softcap on attention logits
    final_logit_softcap: float = 0.0  # gemma2: tanh softcap on LM logits
    sliding_window: int = 0           # 0 = full attention (mixtral/gemma2-local: 4096)
    local_global: bool = False        # gemma2: alternate sliding/global layers
    global_window_long: int = 0       # long-context mode: window used for 'global'
    #                                   layers (documented gemma2 deviation, DESIGN §4)
    rope_theta: float = 10000.0
    use_post_norm: bool = False       # gemma2 sandwich norms
    mlp_act: str = "silu"             # silu (swiglu) | gelu (geglu) | gelu_mlp (2-mat)
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d_model)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 2.0

    # --- SSM (mamba2, used by hybrid) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256              # SSD chunk length for prefill/train

    # --- RWKV6 ---
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64           # decay/token-shift LoRA rank

    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0        # apply the shared attention block every k
    #                                   mamba layers (weights shared, caches not)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0

    # --- modality frontend stubs (DESIGN §4: the one allowed stub) ---
    frontend: str = ""                # "" | "vision" | "audio"
    num_frontend_tokens: int = 0      # image patch tokens prepended to prompt

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""                  # citation for the config numbers

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == SSM

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # --- mamba2 derived dims ---
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    # ------------------------------------------------------------------
    def layer_window(self, layer_idx: int, long_context: bool = False) -> int:
        """Effective attention window of layer ``layer_idx`` (0 = unbounded).

        gemma2 alternates sliding/global; in long-context mode the global
        layers are also windowed (DESIGN.md §8.4).
        """
        if self.local_global:
            if layer_idx % 2 == 0:
                return self.sliding_window
            return self.global_window_long if long_context else 0
        return self.sliding_window

    def supports_long_context(self) -> bool:
        """Whether long_500k decode is sub-quadratic / bounded-state for this arch."""
        if self.family in (SSM, HYBRID):
            return True
        if self.sliding_window > 0 and (not self.local_global or self.global_window_long > 0):
            return True
        if self.local_global and self.global_window_long > 0:
            return True
        return False

    def num_params(self) -> int:
        """Approximate parameter count (used by the perf model and rooflines)."""
        d, hd = self.d_model, self.head_dim_
        p = 0
        p += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            p += self.vocab_size * d  # lm head
        if self.family == SSM:  # rwkv6
            per = (
                4 * d * d  # r,k,v,out (time mix)
                + d * self.rwkv_heads * self.rwkv_head_dim  # gate approx
                + 2 * self.rwkv_lora_dim * d * 2  # decay/x loras
                + 2 * d * self.d_ff  # channel mix
            )
            return p + per * self.num_layers
        attn = d * (self.num_heads * hd) + d * (2 * self.num_kv_heads * hd) + (self.num_heads * hd) * d
        if self.mlp_act == "gelu_mlp":
            mlp = 2 * d * self.d_ff
        else:
            mlp = 3 * d * self.d_ff
        if self.is_moe:
            mlp = self.num_experts * mlp + d * self.num_experts
        if self.family == HYBRID:
            m = self._mamba_params()
            n_shared = self.num_layers // max(self.shared_attn_every, 1)
            return p + m * self.num_layers + (attn + 3 * d * self.d_ff)  # one shared block
        per = attn + mlp
        if self.is_encoder_decoder:
            # encoder layers: attn + gelu mlp; decoder adds cross-attn
            enc = attn + mlp
            dec = 2 * attn + mlp
            return p + enc * self.encoder_layers + dec * self.num_layers
        return p + per * self.num_layers

    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed experts). For 6*N*D FLOPs."""
        if not self.is_moe:
            return self.num_params()
        d = self.d_model
        mlp_all = self.num_experts * 3 * d * self.d_ff
        mlp_act = self.experts_per_token * 3 * d * self.d_ff
        return self.num_params() - (mlp_all - mlp_act) * self.num_layers

    def _mamba_params(self) -> int:
        d, di, ns = self.d_model, self.ssm_d_inner, self.ssm_state
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
        conv = (di + 2 * ns) * self.ssm_conv
        out = di * d
        return in_proj + conv + out + 2 * nh

    def reduced(self, *, layers: int = 2, d_model: int = 256, max_experts: int = 4,
                vocab: int = 512, d_ff: int = 0) -> "ModelConfig":
        """Smoke-test variant: same family/feature set, tiny dims (assignment spec)."""
        ratio = max(1, self.d_model // d_model)
        nh = max(2, self.num_heads // ratio)
        nkv = max(1, min(self.num_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        hd = d_model // nh
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=layers,
            d_model=d_model,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=hd,
            d_ff=d_ff or max(64, self.d_ff // ratio),
            vocab_size=min(self.vocab_size, vocab),
            num_experts=min(self.num_experts, max_experts) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            global_window_long=min(self.global_window_long, 128) if self.global_window_long else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            rwkv_head_dim=32 if self.rwkv else self.rwkv_head_dim,
            rwkv_lora_dim=16 if self.rwkv else self.rwkv_lora_dim,
            shared_attn_every=2 if self.shared_attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            num_frontend_tokens=min(self.num_frontend_tokens, 16),
        )


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
