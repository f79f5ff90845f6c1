"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 1 attn per 3 blocks.
[arXiv:2402.19427; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="rglru_hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    rope_theta=10_000.0, local_window=2048, attn_period=3,
    tie_embeddings=True,
    source="arXiv:2402.19427",
))
