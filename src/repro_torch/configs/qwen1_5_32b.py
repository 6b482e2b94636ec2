"""Qwen1.5-32B [hf:Qwen family] — dense, QKV bias, kv=40 (MHA)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, head_dim=128,
    rope_theta=1000000.0, qkv_bias=True, activation="silu", gated_mlp=True,
    tie_embeddings=False,
    notes="Full MHA (kv=40), QKV bias per Qwen1.5.",
))
