"""Qwen2.5-32B: dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    head_pad=8,  # 40->48 / 14->16: divisible by the 16-way model axis (§Perf Q1)
    source="hf:Qwen/Qwen2.5-0.5B (family); 32B dims per assignment",
))
