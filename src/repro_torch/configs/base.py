"""ArchConfig: the single config record every subsystem consumes.

Each assigned architecture file instantiates one ``ArchConfig`` with the
exact published dimensions and registers it.  ``reduced()`` derives the
small same-family variant used by CPU smoke tests.  ``model_flops``
feeds roofline arithmetic.  ``input_specs`` gives the (shape, dtype) of
every model input of a cell, as the JAX package's ``ShapeDtypeStruct``
stand-ins do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: Optional[int] = None     # sliding-window attention
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (recurrentgemma): block pattern unit, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 2048
    rnn_width: int = 0
    # encdec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500              # stubbed audio-frame embeddings
    # vlm
    xattn_every: int = 0             # cross-attn every k-th layer
    n_patches: int = 1601            # stubbed vision-patch embeddings
    # serving options
    kv_quant: bool = False           # int8 KV cache (paper's 8-bit insight)
    # capability flags
    subquadratic: bool = False       # can run long_500k
    has_decode: bool = True
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))
        assert self.family in FAMILIES, self.family

    # ------------------------------------------------------------------
    # derived sizes
    # ------------------------------------------------------------------

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Total parameters N (embedding included once when tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        mlp_dense = d * f * (3 if self.gated_mlp else 2)
        per_layer: float
        if self.family == "ssm":
            din, n, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = (d * (2 * din + 2 * n + nh)   # in_proj (x,z,B,C,dt)
                         + self.conv_width * (din + 2 * n)
                         + din * d + 2 * nh + din)    # out_proj, A/dt_bias, D
        elif self.family == "moe":
            e_ff = d * f * (3 if self.gated_mlp else 2)
            per_layer = (attn + self.n_experts * e_ff
                         + self.n_shared_experts * e_ff + d * self.n_experts)
        elif self.family == "hybrid":
            pat = self.block_pattern or ("rec",)
            rnn = self.rnn_width or d
            rec = (2 * d * rnn + self.conv_width * rnn + rnn * d
                   + 2 * rnn) + mlp_dense
            att = attn + mlp_dense
            mix = sum(rec if b == "rec" else att for b in pat) / len(pat)
            per_layer = mix
        elif self.family == "encdec":
            # decoder layer: self-attn + cross-attn + mlp; encoder: attn+mlp
            enc = attn + mlp_dense
            dec = 2 * attn + mlp_dense
            return int(emb + self.n_enc_layers * enc + self.n_layers * dec
                       + (self.enc_seq + 4096) * d)  # pos embeds
        elif self.family == "vlm":
            n_x = self.n_layers // max(1, self.xattn_every)
            return int(emb + self.n_layers * (attn + mlp_dense)
                       + n_x * attn)
        else:
            per_layer = attn + mlp_dense
        return int(emb + self.n_layers * per_layer)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        e_ff = d * f * (3 if self.gated_mlp else 2)
        inactive = (self.n_experts - self.top_k) * e_ff
        return int(self.param_count() - self.n_layers * inactive)

    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS for the roofline's useful-compute ratio.

        train: 6 * N_active * tokens (fwd 2x + bwd 4x);
        prefill: 2 * N_active * tokens;
        decode: 2 * N_active * new tokens (= batch).
        Attention score/context flops excluded by convention (6ND).
        """
        n_act = self.active_param_count()
        if shape.kind == "train":
            return 6.0 * n_act * shape.seq_len * shape.global_batch
        if shape.kind == "prefill":
            return 2.0 * n_act * shape.seq_len * shape.global_batch
        return 2.0 * n_act * shape.global_batch

    def input_specs(self, shape: ShapeSpec
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{name: (shape, dtype)}`` of every model input of this cell:
        the tokens, the encdec family's stub frame embeddings and the vlm
        family's stub patch embeddings."""
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "train":
            specs = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        elif shape.kind == "prefill":
            specs = {"tokens": ((b, s), i32)}
        else:   # decode: one new token against an S-long cache
            specs = {"tokens": ((b, 1), i32), "cache_index": ((), i32)}
        if self.family == "encdec":
            # stubbed conv-frontend output: precomputed frame embeddings
            specs["encoder_embeds"] = ((b, self.enc_seq, self.d_model),
                                       torch.bfloat16)
        if self.family == "vlm":
            # stubbed vision tower: precomputed patch embeddings
            specs["vision_embeds"] = ((b, self.n_patches, self.d_model),
                                      torch.bfloat16)
        return specs

    def supports(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """(runnable, reason-if-not) for an (arch x shape) cell."""
        if shape.kind == "decode" and not self.has_decode:
            return False, "encoder-only: no decode step"
        if shape.name == "long_500k" and not self.subquadratic:
            return False, "full attention is quadratic at 500k (DESIGN.md §6)"
        return True, ""

    # ------------------------------------------------------------------
    # smoke-test variant
    # ------------------------------------------------------------------

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        def shrink_heads(h):
            return max(1, min(h, 4))
        kv = max(1, min(self.n_kv_heads, 2))
        h = max(kv, shrink_heads(self.n_heads))
        h = (h // kv) * kv or kv
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 * max(1, len(self.block_pattern)
                                                or 1)),
            d_model=128, n_heads=h, n_kv_heads=kv,
            d_ff=256, vocab=512, head_dim=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free capacity so decode == teacher-forced forward in tests
            capacity_factor=2.0 if self.n_experts else self.capacity_factor,
            n_shared_experts=min(self.n_shared_experts, 1)
            if self.n_shared_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            rnn_width=128 if self.rnn_width else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16 if self.family == "encdec" else self.enc_seq,
            xattn_every=2 if self.xattn_every else 0,
            n_patches=8 if self.family == "vlm" else self.n_patches,
            local_window=32,
            window=min(self.window, 64) if self.window else None,
        )


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    return sorted(_REGISTRY)
