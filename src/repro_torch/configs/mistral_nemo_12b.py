"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense, 128k ctx."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1000000.0, activation="silu", gated_mlp=True,
    tie_embeddings=False,
    notes="GQA kv=8, SwiGLU, RMSNorm, 128k context (rope theta 1e6).",
))
