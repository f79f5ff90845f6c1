"""InternVL2-1B: InternViT frontend (STUB) + Qwen2-0.5B backbone. [arXiv:2404.16821; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    frontend="vit",
    head_pad=2,  # 40->48 / 14->16: divisible by the 16-way model axis (§Perf Q1)
    source="arXiv:2404.16821 (backbone per assignment; ViT is a stub)",
))
