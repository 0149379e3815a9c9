"""Llama-4-Maverick-400B-A17B — MoE 128 experts top-1 + shared expert,
early-fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    attention="gqa",
    num_experts=128, experts_per_token=1, shared_expert_ff=8192,
    moe_every=2,
)
