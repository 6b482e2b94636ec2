"""Whisper-medium [arXiv:2212.04356] — enc-dec; conv frontend stubbed."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64,
    activation="gelu", gated_mlp=False, norm="layernorm",
    n_enc_layers=24, enc_seq=1500,
    notes="24 enc + 24 dec layers; conv frontend is a stub (input_specs "
          "provides precomputed frame embeddings). Decode shapes exercise "
          "the decoder with a 32k self-cache per the assignment shape "
          "(beyond Whisper's 448 but well-defined on the backbone).",
))
