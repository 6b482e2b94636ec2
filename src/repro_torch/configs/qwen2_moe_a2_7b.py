"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60e top-4 + 4 shared."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, head_dim=128,
    activation="silu", gated_mlp=True, qkv_bias=True,
    n_experts=60, top_k=4, n_shared_experts=4,
    notes="60 routed experts top-4 plus 4 always-on shared experts; "
          "expert d_ff=1408.",
))
