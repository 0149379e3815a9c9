"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
EnCodec frontend stubbed per assignment (input_specs supplies precomputed
frame embeddings)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    attention="gqa", frontend="audio_stub",
)
