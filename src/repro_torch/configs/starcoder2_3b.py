"""StarCoder2-3B [arXiv:2402.19173; hf] — dense, GQA kv=2, RoPE."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, head_dim=128,
    rope_theta=999999.0, qkv_bias=True, activation="gelu", gated_mlp=False,
    norm="layernorm", tie_embeddings=True,
    notes="GQA kv=2, RoPE, non-gated GeLU MLP, LayerNorm (per paper).",
))
