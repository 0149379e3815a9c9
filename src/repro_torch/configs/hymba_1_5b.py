"""Hymba-1.5B — hybrid parallel attention+SSM heads [arXiv:2411.13676; hf].

Sliding-window attention on most layers (3 full-attention layers: first,
middle, last) makes it eligible for the 524k long-context decode shape.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1_5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    attention="swa", window=1024, global_layers=(0, 15, 31),
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)
