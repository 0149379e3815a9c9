"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base;
unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    attention="gqa",
    num_experts=16, experts_per_token=4,
)
