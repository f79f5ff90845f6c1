"""Mixtral-8x22B: 8-expert top-2 MoE with sliding-window attention. [arXiv:2401.04088; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    rope_theta=1_000_000.0, window=4096,
    n_experts=8, top_k=2, norm_topk_prob=True,
    source="arXiv:2401.04088 (per assignment: 8e top-2, SWA)",
))
