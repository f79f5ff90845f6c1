"""Command-R 35B: dense GQA, no biases. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    qkv_bias=False, rope_theta=10_000.0, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
))
