"""Llama-3.2-Vision-90B [hf:meta-llama] — cross-attn image layers (stub)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    rope_theta=500000.0, activation="silu", gated_mlp=True,
    tie_embeddings=False, xattn_every=5, n_patches=1601,
    notes="100 decoder layers; gated cross-attention to stubbed vision "
          "patch embeddings every 5th layer (20 cross-attn layers).",
))
