"""StableLM-2-12B [hf:stabilityai/stablelm-2-12b; hf]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    attention="gqa",
)
