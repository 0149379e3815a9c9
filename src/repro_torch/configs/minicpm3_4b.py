"""MiniCPM3-4B — MLA (multi-head latent attention) [hf:openbmb/MiniCPM3-4B]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=96,
    attention="mla",
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
)
