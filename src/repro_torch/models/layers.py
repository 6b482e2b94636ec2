"""Shared model components: norms, RoPE, GQA attention (the full-sequence
form through the flash-attention kernel, and one-token decode against the
int8 or the bf16 KV cache), the MLP, and the int8 embedding and LM head.

Conventions (as in ``repro/models/layers.py``):
- plain functions over param dicts of tensors;
- every matmul routes through :func:`repro_torch.core.qlinear.linear`;
- the KV cache keeps the reference's (B, S, KV, hd) layout — int8 with
  scales (B, S, KV, 1), or bf16 — or its paged (NB, bs, KV, hd)
  physical blocks behind per-row block tables, and is written in place;
- cross-attention (the encdec family) reads a source: projected from it
  in the full-sequence form, or pre-projected per slot (``xk``, ``xv``
  behind a per-row ``xlen`` frontier) in the decode form.

A sliding-window ring is a contiguous cache whose rows the caller writes
at ``position % window`` and reads below ``min(position + 1, window)``:
the hybrid family's bf16 ring (``models/rglru.py``) and a windowed dense
or MoE config's int8 or bf16 one (mixtral; ``models/transformer.py``).
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
from repro_torch.kernels.decode_attention import paged_gather

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
    use_rope: bool = True


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


def tree_sum(x: Tensor, dim: int = -1) -> Tensor:
    """Sum over ``dim`` in one fixed pairwise order: as if zero-padded to
    a power of two, then halves added until one is left.  Each output is
    the same chain of f32 adds whatever the other dims hold or how the
    tensor lies in memory, on any device; a matmul or a ``sum`` picks its
    reduction layout from the whole shape on the card (cuBLAS, the
    reduction kernels), so a row's bits could depend on the batch.  A
    ragged first level adds the zero padding without making it: the
    places past the tail are ``x + 0.0``, as the padded sum has them."""
    dim = dim % x.ndim
    n = x.shape[dim]
    half = (1 << (n - 1).bit_length()) // 2
    if n > 1 and 2 * half != n:
        k = n - half
        shape = list(x.shape)
        shape[dim] = half
        out = x.new_empty(shape)
        torch.add(x.narrow(dim, 0, k), x.narrow(dim, half, k),
                  out=out.narrow(dim, 0, k))
        torch.add(x.narrow(dim, k, half - k), 0.0,
                  out=out.narrow(dim, k, half - k))
        x = out
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def bf16_cache_attention(q: Tensor, ck: Tensor, cv: Tensor,
                         valid_len: Tensor) -> Tensor:
    """One-token GQA attention against a bf16 cache, the reference's einsum
    path (``layers.py:403-446``, non-append form): q (B, KV, G, hd), the
    cache (B, S, KV, hd), slots below ``valid_len`` (B,) take part; f32
    out (B, KV, G, hd).  q, the cache and the probabilities are rounded to
    bf16 and multiplied in f32, so no reduced-precision (tf32, bf16)
    product or sum enters; the products are summed by :func:`tree_sum`,
    so a row's bits do not depend on the batch, the G or the KV heads
    beside it (the engine's parity with its batch-1 reference).  Plain
    PyTorch: the reference has no kernel here."""
    hd = q.shape[-1]
    smax = ck.shape[1]
    qf = q.to(torch.bfloat16).float()[:, :, :, None, :]     # (B, KV, G, 1, hd)
    kf = ck.to(torch.bfloat16).float().permute(0, 2, 1, 3)  # (B, KV, S, hd)
    scores = tree_sum(qf * kf[:, :, None]) * hd ** -0.5     # (B, KV, G, S)
    valid = (torch.arange(smax, device=q.device)[None, :]
             < valid_len.reshape(-1, 1))                    # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    pf = probs.to(torch.bfloat16).float()[:, :, :, None, :]  # (B, KV, G, 1, S)
    vf = cv.to(torch.bfloat16).float().permute(0, 2, 3, 1)   # (B, KV, hd, S)
    return tree_sum(pf * vf[:, :, None])                     # (B, KV, G, hd)


def cross_cache_attention(q: Tensor, xk: Tensor, xv: Tensor,
                          xlen: Tensor) -> Tensor:
    """Attention of q (B, s, H, hd) over a pre-projected source xk, xv (B,
    Se, KV, hd), each batch row masked at its own frontier ``xlen`` (B,):
    the reference's masked chunked path (``_chunked_attention`` with
    ``kv_valid_len``, which its decode step takes for every primed
    source).  f32 scores and probabilities from q and the source as they
    are; the products are summed by :func:`tree_sum`, so a row's bits do
    not depend on the batch.  The source is multiplied as it lies (a
    bf16 operand of an f32 product is widened exactly in the kernel, with
    no f32 copy of the source).  Out (B, s, H, hd) f32.  Plain PyTorch:
    the reference runs no kernel here."""
    b, s, h, hd = q.shape
    se, kvh = xk.shape[1], xk.shape[2]
    g = h // kvh
    # products laid out (B, s, Se, KV, G, hd): the source broadcasts
    # over s and G as it lies, and the sum over Se adds contiguous halves
    qf = q.float().reshape(b, s, 1, kvh, g, hd)
    scores = tree_sum(qf * xk[:, None, :, :, None, :]) * hd ** -0.5
    scores = scores.permute(0, 1, 3, 4, 2).contiguous()     # (B, s, KV, G, Se)
    valid = (torch.arange(se, device=q.device)[None, :]
             < xlen.reshape(-1, 1))                          # (B, Se)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).permute(0, 1, 4, 2, 3)
    out = tree_sum(probs[..., None] * xv[:, None, :, :, None, :], dim=2)
    return out.reshape(b, s, h, hd)


def attention(p: dict, x: Tensor, cfg: AttnConfig, *,
              mode: QuantMode = FP,
              rope: Optional[Tuple[Tensor, Tensor]] = None,
              kv_cache: Optional[Tuple[Tensor, ...]] = None,
              cache_index=None, valid_len: Optional[Tensor] = None,
              block_tables: Optional[Tensor] = None,
              source: Optional[Tensor] = None,
              cross: Optional[Tuple[Tensor, Tensor, Tensor]] = None
              ) -> Tensor:
    """GQA attention in three modes.

    - Full sequence (``kv_cache=None``; prefill, the service curve): x is
      (B, S, D), RoPE at ``rope`` (the positions 0..S-1) where
      ``cfg.use_rope``, KV expanded to H heads and the fused
      flash-attention kernel with ``cfg.causal`` and ``cfg.window``.  With
      ``source`` (B, Se, D) k and v are projected from the source and the
      kernel attends over all of it, not causal and without RoPE
      (cross-attention).
    - Cross-attention against a primed source: ``cross = (xk, xv, xlen)``,
      the source's pre-projected k and v (B, Se, KV, hd) and each row's
      frontier (B,) (:func:`cross_cache_attention`); only q and the output
      projection run.
    - Decode (x is (B, s, D)) against one layer's cache: ``kv_cache`` is
      the int8 ``(k, v, k_scale, v_scale)`` or the bf16 ``(k, v)``;
      ``rope`` is :func:`rope_cos_sin` of the token positions and
      ``cache_index`` the write positions (see :func:`cache_write`).  The
      s new tokens' k/v (int8: quantized) are written into the cache in
      place first; attention then covers every slot below ``valid_len``,
      the new tokens included — the reference's non-append form: the
      fused int8 kernel, or :func:`bf16_cache_attention`.  ``valid_len``
      is (B,) int32, one frontier for every query row of a batch row (the
      reference's s > 1 form), or (B, s), one per query row (chunked
      prefill: row i at its own token's place).  With ``block_tables``
      (B, MB) int32 the cache is paged: its leaves are physical blocks,
      ``cache_index`` a ``(blocks, offsets)`` pair, and each row is read
      through its table.

    For s > 1 (or a (B, s) ``valid_len``) the B·s query rows attend as
    rows of their own, through the paged kernel with each batch row's
    table repeated s times; a contiguous int8 cache (B, S, ...) is read
    as B blocks of S slots, row b's table ``[b]``, and a bf16 cache is
    gathered once per query row.  A row's bits are then the one-token
    step's at its frontier (the kernels' rows do not depend on the batch,
    the block size or the cache's capacity).

    Head h reads kv head h // G."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(p["wq"], x, mode=mode).reshape(b, s, h, hd)
    if cross is not None:
        out = cross_cache_attention(q, *cross).to(x.dtype)
        return linear(p["wo"], out.reshape(b, s, h * hd), mode=mode)
    src = x if source is None else source
    k = linear(p["wk"], src, mode=mode).reshape(b, src.shape[1], kvh, hd)
    v = linear(p["wv"], src, mode=mode).reshape(b, src.shape[1], kvh, hd)
    if cfg.use_rope and source is None:
        q = rotate(q, *rope)
        k = rotate(k, *rope)
    if kv_cache is None:
        self_attn = source is None
        out = kops.flash_attention(q, _expand_kv(k, h), _expand_kv(v, h),
                                   causal=cfg.causal and self_attn,
                                   window=cfg.window if self_attn else None)
        return linear(p["wo"], out.reshape(b, s, h * hd), mode=mode)
    g = h // kvh
    rows = b * s
    if s != 1 or valid_len.ndim == 2:
        # every query row on its own: (B·s,) frontiers and tables (the
        # kernels take contiguous tensors; a reshape of an expand may be a
        # strided view)
        valid_len = valid_len.reshape(b, -1).expand(b, s).reshape(
            rows).contiguous()
        if block_tables is None:
            block_tables = torch.arange(b, dtype=torch.int32,
                                        device=x.device)[:, None]
        block_tables = block_tables[:, None].expand(
            b, s, block_tables.shape[1]).reshape(rows, -1).contiguous()
    if len(kv_cache) == 4:
        ck, cv, cks, cvs = kv_cache
        kq, ks = q8(k)
        vq, vs = q8(v)
        for c, new in ((ck, kq), (cv, vq), (cks, ks), (cvs, vs)):
            cache_write(c, new, cache_index)
        out = kops.decode_attention(q.reshape(rows, kvh, g, hd), ck, cv,
                                    cks, cvs, valid_len,
                                    block_tables=block_tables,
                                    out_dtype=torch.float32)
    else:
        ck, cv = kv_cache
        cache_write(ck, k.to(ck.dtype), cache_index)
        cache_write(cv, v.to(cv.dtype), cache_index)
        if block_tables is not None:
            ck, cv = paged_gather(ck, block_tables), paged_gather(
                cv, block_tables)
        out = bf16_cache_attention(q.reshape(rows, kvh, g, hd), ck, cv,
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


# the head's columns are padded to a multiple of this (the W8A16 kernels'
# N % 4 == 0)
HEAD_ALIGN = 4


def lm_head(table: QTensor) -> QTensor:
    """The (D, Vp) int8 head of a quantized (V, D) table, with the table's
    per-row scales as per-column scales: a transposed, contiguous copy of
    the values, its columns padded with zeros (values and scales) up to Vp,
    the next multiple of HEAD_ALIGN (whisper's 51,865), as the reference's
    wrapper pads N to its tile.  Made at the table's first use and kept for
    as long as the table lives (the weights are not written after they are
    made).  A decode step then reads the head and copies nothing."""
    head = _HEADS.get(table.values)
    if head is None:
        pad = -table.values.shape[0] % HEAD_ALIGN
        head = _HEADS[table.values] = QTensor(
            values=F.pad(table.values.t(), (0, pad)).contiguous(),
            scale=F.pad(table.scale.reshape(-1), (0, pad)))
    return head


def unembed(p: dict, x: Tensor, compute_dtype=torch.bfloat16, *,
            path: str = "gemv") -> Tensor:
    """(Tied) LM head: f32 logits = x @ table.T.  A quantized table's
    per-row scales are per-output-column scales of the head, so the head
    runs through the same weight-only int8 matmul as every W8A16
    projection (f32 out, through the kernel ``path`` names), on the
    table's (D, Vp) head (:func:`lm_head`).  A padded head's logits are
    cut back to the table's V columns; every column is computed on its
    own, so the padding changes no logit's bits."""
    table = p["table"]
    if isinstance(table, QTensor):
        out = kops.qmatmul(x.to(compute_dtype), lm_head(table),
                           out_dtype=torch.float32, path=path)
        v = table.values.shape[0]
        return out if out.shape[-1] == v else out[..., :v]
    return torch.matmul(x.to(compute_dtype).float(),
                        table.to(compute_dtype).float().t())
