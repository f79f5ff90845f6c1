"""Qwen1.5-32B: dense MHA-heavy decoder (kv=40) with QKV bias. [hf:Qwen/Qwen1.5-*; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    # head_pad intentionally 0: MHA (kv=40) cannot pad q-heads alone, so
    # this arch keeps the context-parallel attention path (§Perf Q1 note)
    source="hf:Qwen/Qwen1.5-0.5B (family); 32B dims per assignment",
))
