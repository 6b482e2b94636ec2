"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSM (SSD)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256, conv_width=4,
    subquadratic=True,
    notes="SSD (state-space duality): chunked intra/inter computation; "
          "attention-free -> long_500k runnable.",
))
