"""Mamba2-2.7B — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2_7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attention="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)
