"""InternVL2-26B — InternViT frontend (stubbed) + InternLM2-20B-style LM
backbone [arXiv:2404.16821; hf].  Per assignment, ``input_specs()`` provides
precomputed patch embeddings; the backbone below is the transformer."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    attention="gqa", frontend="vlm_stub",
)
