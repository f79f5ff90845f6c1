"""MusicGen-medium: decoder-only over EnCodec tokens (frontend STUB). [arXiv:2306.05284; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium", family="dense",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    qkv_bias=False, rope_theta=10_000.0,
    frontend="encodec",
    source="arXiv:2306.05284 (EnCodec frame embeddings are a stub)",
))
