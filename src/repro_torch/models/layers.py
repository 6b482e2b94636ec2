"""Shared model components: norms, RoPE, GQA attention (the full-sequence
form through the flash-attention kernel, and one-token decode against the
int8 or the bf16 KV cache), the MLP, and the int8 embedding and LM head.

Conventions (as in ``repro/models/layers.py``):
- plain functions over param dicts of tensors;
- every matmul routes through :func:`repro_torch.core.qlinear.linear`;
- the KV cache keeps the reference's (B, S, KV, hd) layout — int8 with
  scales (B, S, KV, 1), or bf16 — or, int8 only, its paged
  (NB, bs, KV, hd) physical blocks behind per-row block tables, and is
  written in place.

Not ported yet: sliding-window ring caches and cross-attention (ROADMAP
queue 1, item 13); multi-token attention against a cache (item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.qlinear import FP, QuantMode, linear
from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attention import NEG_INF
# the reference keeps paged_gather here; it lives beside the paged plain
# version, which needs it (kernels import nothing from models)
from repro_torch.kernels.decode_attention import paged_gather  # noqa: F401

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Norms (f32 compute, cast back)
# ---------------------------------------------------------------------------

def rmsnorm(p: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    """f32 RMSNorm, cast back.  ``F.rms_norm`` reduces each row on its
    own (one block per row on the card), as ``F.layer_norm`` does; a
    ``mean`` over the last dim picks its reduction layout from the row
    count on the card, so a row's bits would depend on the batch."""
    out = F.rms_norm(x.float(), x.shape[-1:], p["scale"].float(), eps)
    return out.to(x.dtype)


def layernorm(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    """f32 LayerNorm, cast back.  ``F.layer_norm`` reduces each row in one
    fixed order whatever the number of rows (one block per row on the
    card), which the engine's bit parity with its batch-1 reference needs;
    a ``mean`` over the last dim does not promise that on the card."""
    out = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                       p["bias"].float(), eps)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: Tensor, head_dim: int,
                 theta: float = 10000.0) -> Tuple[Tensor, Tensor]:
    """cos / sin of the rotation angles, (B, S, 1, hd/2), for positions
    (B, S).  With :func:`rotate` this is the reference's ``apply_rope``,
    split so that one decode step computes the angles once for every
    layer."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Half-split rotation of x (B, S, H, hd) in f32, cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA: full sequence, or decode against the int8 or bf16 cache)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window size (None = full)
    causal: bool = True


def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each KV group: head h
    reads kv head h // G."""
    kvh = k.shape[2]
    if kvh == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kvh, dim=2)


def q8(t: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-(token, head) int8 quantization of new k/v (..., hd): scale is
    max(amax, 1e-6) / 127 — as a multiply by f32(1/127), which is what XLA
    makes of the reference's division by a constant under jit — and values
    round(t / scale) half-to-even."""
    tf = t.float()
    amax = torch.clamp_min(tf.abs().amax(-1, keepdim=True), 1e-6)
    sc = amax * (1.0 / 127.0)
    return torch.round(tf / sc).to(torch.int8), sc


def cache_write(c: Tensor, new: Tensor, idx) -> None:
    """Write ``new`` (B, s, ...) into ``c`` in place: at positions ``idx
    .. idx + s - 1`` for an int ``idx`` (lockstep decode into (B, S,
    ...)), or, where every row writes at its own places, through a pair
    of long tensors that index (B, s) places — ``(rows, positions)`` into
    contiguous rows (B, S, ...) (the slot engine), or ``(blocks,
    offsets)`` into paged blocks (NB, bs, ...), the in-place form of the
    reference's ``paged_append``.  Retired rows' tables point at trash
    block 0, so several rows may write the same place: plain assignment
    (never an accumulating one) leaves one of them there, and trash is
    never read unmasked."""
    if isinstance(idx, int):
        c[:, idx:idx + new.shape[1]] = new
    else:
        c[idx] = new


def bf16_cache_attention(q: Tensor, ck: Tensor, cv: Tensor,
                         valid_len: Tensor) -> Tensor:
    """One-token GQA attention against a bf16 cache, the reference's einsum
    path (``layers.py:403-446``, non-append form): q (B, KV, G, hd), the
    cache (B, S, KV, hd), slots below ``valid_len`` (B,) take part; f32
    out (B, KV, G, hd).  q, the cache and the probabilities are rounded to
    bf16 and multiplied in f32, so no reduced-precision (tf32, bf16)
    product or sum enters.  Plain PyTorch: the reference has no kernel
    here."""
    hd = q.shape[-1]
    smax = ck.shape[1]
    qf = q.to(torch.bfloat16).float()
    kf = ck.to(torch.bfloat16).float().permute(0, 2, 3, 1)   # (B, KV, hd, S)
    scores = torch.matmul(qf, kf) * hd ** -0.5               # (B, KV, G, S)
    valid = (torch.arange(smax, device=q.device)[None, :]
             < valid_len.reshape(-1, 1))                     # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    vf = cv.to(torch.bfloat16).float().permute(0, 2, 1, 3)   # (B, KV, S, hd)
    return torch.matmul(probs.to(torch.bfloat16).float(), vf)


def attention(p: dict, x: Tensor, cfg: AttnConfig, *,
              mode: QuantMode = FP, rope: Tuple[Tensor, Tensor],
              kv_cache: Optional[Tuple[Tensor, ...]] = None,
              cache_index=None, valid_len: Optional[Tensor] = None,
              block_tables: Optional[Tensor] = None) -> Tensor:
    """GQA attention in two modes.

    - Full sequence (``kv_cache=None``; prefill, the service curve): x is
      (B, S, D), RoPE at ``rope`` (the positions 0..S-1), KV expanded to H
      heads and the fused flash-attention kernel with ``cfg.causal`` and
      ``cfg.window``.
    - Decode (x is (B, 1, D)) against one layer's cache: ``kv_cache`` is
      the int8 ``(k, v, k_scale, v_scale)`` or the bf16 ``(k, v)``;
      ``rope`` is :func:`rope_cos_sin` of the token positions and
      ``cache_index`` the write position (see :func:`cache_write`).  The
      new token's k/v (int8: quantized) are written into the cache in
      place first; attention then covers every slot below ``valid_len``
      (B,) int32, the new token included — the reference's non-append
      form: the fused int8 kernel, or :func:`bf16_cache_attention`.  With
      ``block_tables`` (B, MB) int32 the int8 cache is paged: its leaves
      are physical blocks, ``cache_index`` a ``(blocks, offsets)`` pair,
      and the kernel reads each row through its table.

    Head h reads kv head h // G."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x, mode=mode).reshape(b, s, h, hd)
    k = linear(p["wk"], x, mode=mode).reshape(b, s, kvh, hd)
    v = linear(p["wv"], x, mode=mode).reshape(b, s, kvh, hd)
    q = rotate(q, *rope)
    k = rotate(k, *rope)
    if kv_cache is None:
        out = kops.flash_attention(q, _expand_kv(k, h), _expand_kv(v, h),
                                   causal=cfg.causal, window=cfg.window)
        return linear(p["wo"], out.reshape(b, s, h * hd), mode=mode)
    if s != 1:
        raise NotImplementedError(
            "the port attends one token per step against a cache; "
            "multi-token cache attention comes with speculative decoding "
            "(ROADMAP queue 1, item 14)")
    g = h // kvh
    if len(kv_cache) == 4:
        ck, cv, cks, cvs = kv_cache
        kq, ks = q8(k)
        vq, vs = q8(v)
        for c, new in ((ck, kq), (cv, vq), (cks, ks), (cvs, vs)):
            cache_write(c, new, cache_index)
        out = kops.decode_attention(q.reshape(b, kvh, g, hd), ck, cv, cks,
                                    cvs, valid_len,
                                    block_tables=block_tables,
                                    out_dtype=torch.float32)
    else:
        ck, cv = kv_cache
        cache_write(ck, k.to(ck.dtype), cache_index)
        cache_write(cv, v.to(cv.dtype), cache_index)
        out = bf16_cache_attention(q.reshape(b, kvh, g, hd), ck, cv,
                                   valid_len)
    out = out.to(x.dtype).reshape(b, s, h * hd)
    return linear(p["wo"], out, mode=mode)


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> Tuple[Tensor, Tensor]:
    """One layer's zeroed (B, S, KV, hd) k and v cache."""
    shape = (batch, s_max, n_kv, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p: dict, x: Tensor, *, gated: bool, activation: str,
        mode: QuantMode = FP) -> Tensor:
    if gated:
        g = linear(p["w_gate"], x, activation=activation, mode=mode)
        u = linear(p["w_up"], x, mode=mode)
        h = g * u
    else:
        h = linear(p["w_up"], x, activation=activation, mode=mode)
    return linear(p["w_down"], h, mode=mode)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed(p: dict, tokens: Tensor, compute_dtype=torch.bfloat16) -> Tensor:
    table = p["table"]
    if isinstance(table, QTensor):
        # per-row scales: gather int8 rows, dequantize the gathered slice
        rows = table.values[tokens].to(compute_dtype)
        scale = table.scale.reshape(-1)[tokens][..., None]
        return rows * scale.to(compute_dtype)
    return table.to(compute_dtype)[tokens]


# int8 table (V, D) -> its (D, V) head, made once per table
_HEADS = WeakIdKeyDictionary()


def lm_head(table: QTensor) -> QTensor:
    """The (D, V) int8 head of a quantized (V, D) table, with the table's
    per-row scales as per-column scales: a transposed, contiguous copy of
    the values, made at the table's first use and kept for as long as the
    table lives (the weights are not written after they are made).  A
    decode step then reads the head and copies nothing."""
    head = _HEADS.get(table.values)
    if head is None:
        head = _HEADS[table.values] = QTensor(
            values=table.values.t().contiguous(),
            scale=table.scale.reshape(-1))
    return head


def unembed(p: dict, x: Tensor, compute_dtype=torch.bfloat16, *,
            path: str = "gemv") -> Tensor:
    """(Tied) LM head: f32 logits = x @ table.T.  A quantized table's
    per-row scales are per-output-column scales of the head, so the head
    runs through the same weight-only int8 matmul as every W8A16
    projection (f32 out, through the kernel ``path`` names), on the
    table's (D, V) head (:func:`lm_head`)."""
    table = p["table"]
    if isinstance(table, QTensor):
        return kops.qmatmul(x.to(compute_dtype), lm_head(table),
                            out_dtype=torch.float32, path=path)
    return torch.matmul(x.to(compute_dtype).float(),
                        table.to(compute_dtype).float().t())
