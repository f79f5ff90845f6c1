"""Qwen1.5/2-MoE-A2.7B: 60 routed top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    n_experts=60, top_k=4, n_shared_experts=4, moe_d_ff=1408,
    norm_topk_prob=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
