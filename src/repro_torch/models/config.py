"""Architecture configuration — one frozen dataclass drives every model."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # attention flavour
    attention: str = "gqa"        # gqa | mla | swa | none
    qkv_bias: bool = False
    window: int = 0               # sliding-window size (swa); 0 = full
    global_layers: Sequence[int] = ()  # swa archs: layers with full attention

    # MLA (DeepSeek/MiniCPM3 style multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    shared_expert_ff: int = 0     # llama4-style always-on shared expert
    moe_every: int = 1            # MoE on every Nth layer (llama4: 2), dense
                                  # SwiGLU (d_ff) on the rest

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # modality frontend (stubbed per assignment: input_specs() provides
    # precomputed patch/frame embeddings)
    frontend: str = "none"        # none | vlm_stub | audio_stub

    # numerics / training
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "full"           # none | full | dots
    loss_chunk: int = 1024        # tokens per chunked-xent slab
    tie_embeddings: bool = False

    # distribution/perf knobs (§Perf hillclimb; defaults = paper-baseline)
    attn_kv_chunk: int = 1024     # flash KV block
    seq_shard_activations: bool = False  # Megatron-SP style: shard the
                                         # residual stream's seq dim over
                                         # "model" between blocks

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived quantities ------------------------------------------------

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def uses_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 524k long-context decode shape."""
        return self.uses_ssm or (self.attention == "swa")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if not self.is_attention_free:
            if self.attention == "mla":
                qr = self.q_lora_rank or d
                per_layer += d * qr + qr * self.num_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim)
                per_layer += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                per_layer += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_head_dim + self.v_head_dim)
                per_layer += self.num_heads * self.v_head_dim * d
            else:
                hd = self.head_dim
                per_layer += d * self.num_heads * hd          # Wq
                per_layer += 2 * d * self.num_kv_heads * hd   # Wk, Wv
                per_layer += self.num_heads * hd * d          # Wo
        if self.uses_ssm:
            di, ds = self.d_inner, self.ssm_state
            per_layer += d * (2 * di + 2 * self.ssm_groups * ds + self.ssm_heads)
            per_layer += di * d
        moe_layers = (L // self.moe_every) if self.uses_moe else 0
        if self.uses_moe:
            moe_per_layer = d * self.num_experts               # router
            moe_per_layer += self.num_experts * 3 * d * self.d_ff
            if self.shared_expert_ff:
                moe_per_layer += 3 * d * self.shared_expert_ff
            dense_per_layer = 3 * d * self.d_ff                # interleaved
            total += moe_layers * moe_per_layer
            total += (L - moe_layers) * dense_per_layer
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff                     # SwiGLU
        total += L * per_layer
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed experts) for 6·N_active·D."""
        if not self.uses_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        moe_layers = L // self.moe_every
        inactive = (self.num_experts - self.experts_per_token) * 3 * d * self.d_ff
        return self.param_count() - moe_layers * inactive


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.num_heads else 0,
        window=min(cfg.window, 32) if cfg.window else 0,
        global_layers=tuple(g for g in cfg.global_layers if g < 2),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        # capacity-dropping makes MoE outputs depend on *other* tokens in
        # the batch (not causally consistent); keep tiny-config capacity
        # non-binding so prefill/decode consistency tests are exact
        moe_capacity_factor=8.0,
        shared_expert_ff=64 if cfg.shared_expert_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        loss_chunk=64,
        remat="none",
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-tiny", **small)
