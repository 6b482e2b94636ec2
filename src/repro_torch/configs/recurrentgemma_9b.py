"""RecurrentGemma-9B [arXiv:2402.19427] — RG-LRU + local attention, 1:2."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    activation="gelu", gated_mlp=True,
    block_pattern=("rec", "rec", "attn"), local_window=2048, rnn_width=4096,
    subquadratic=True,
    notes="Griffin pattern: 2 RG-LRU recurrent blocks per local-attn block "
          "(window 2048, MQA kv=1); fixed-size state -> long_500k runnable.",
))
