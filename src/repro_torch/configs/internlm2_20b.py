"""InternLM2-20B [arXiv:2403.17297; hf] — dense, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, head_dim=128,
    rope_theta=1000000.0, activation="silu", gated_mlp=True,
    tie_embeddings=False,
    notes="GQA kv=8, SwiGLU, RMSNorm.",
))
