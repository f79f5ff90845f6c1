"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay. [arXiv:2404.05892; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b", family="rwkv6",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # 64-dim wkv heads
    d_ff=7168, vocab_size=65536, head_dim=64,
    source="arXiv:2404.05892 (Finch 1.6B: L24 D2048)",
))
