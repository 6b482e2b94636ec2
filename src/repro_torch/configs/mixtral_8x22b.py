"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, SWA per assignment."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    rope_theta=1000000.0, activation="silu", gated_mlp=True,
    n_experts=8, top_k=2, window=4096, tie_embeddings=False,
    subquadratic=True,
    notes="8 experts top-2; sliding-window attention (4096) per the "
          "assignment spec -> long_500k runnable (bounded KV).",
))
