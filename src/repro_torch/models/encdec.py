"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]: the port of
``repro/models/encdec.py``.

The conv audio frontend is a stub, as in the reference: ``input_specs``
feeds precomputed frame embeddings (B, enc_seq, D).  The backbone:
- encoder: bidirectional transformer (LayerNorm, GeLU MLP, sinusoidal
  positions), every attention layer through the flash-attention kernel,
  not causal;
- decoder: causal self-attention, cross-attention to the encoder output,
  GeLU MLP, learned positions ``dec_pos[pos % 4096]``.
No RoPE.

Serving primes each request once (:func:`prime_slot`): the encoder runs
over its source and every decoder layer's cross k/v is projected from the
encoder output, into the slot's row of the cache's slot-resident leaves
``xk``, ``xv`` (L, B, enc_seq, KV, hd) bf16 with the row's frontier
``xlen`` (B,); a decode step reads them (masked at the row's own
``xlen``) and never writes them.  The self-attention cache is bf16
whatever ``cfg.kv_quant`` says, as the reference's ``init_cache`` makes
it, contiguous or paged.

Layout differences from the reference, as in ``models/transformer.py``:
``params["enc_layers"]`` and ``params["dec_layers"]`` are lists of
per-layer dicts, and the caches are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode, linear
from repro_torch.core.quant import quantize_tree
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Tensor = torch.Tensor

DEC_POS_TABLE = 4096     # learned decoder positions: table[pos % 4096]


def _attn_cfg(cfg: ArchConfig, causal: bool) -> L.AttnConfig:
    return L.AttnConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, causal=causal, use_rope=False)


def _sinusoid(s: int, d: int, device) -> Tensor:
    """(s, d) f32 sinusoidal positions: sin then cos of pos / 10000^(2i/d)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_enc_layer(gen, cfg: ArchConfig, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"ln_attn": T._norm(cfg, **kw),
            "attn": T.init_attention(gen, cfg, **kw),
            "ln_mlp": T._norm(cfg, **kw),
            "mlp": T.init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, **kw)}


def init_dec_layer(gen, cfg: ArchConfig, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"ln_self": T._norm(cfg, **kw),
            "self_attn": T.init_attention(gen, cfg, **kw),
            "ln_cross": T._norm(cfg, **kw),
            "cross_attn": T.init_attention(gen, cfg, **kw),
            "ln_mlp": T._norm(cfg, **kw),
            "mlp": T.init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, **kw)}


def _dec_pos(gen, cfg: ArchConfig, dtype, device) -> Tensor:
    t = torch.empty((DEC_POS_TABLE, cfg.d_model), dtype=torch.float32,
                    device=device)
    t.normal_(generator=gen)
    return t.mul_(0.01).to(dtype)


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None) -> dict:
    """Random params from ``gen``, drawn in the reference's order (the
    embedding table, the decoder positions, the encoder layers, the
    decoder layers); same distributions, other numbers (tests copy the
    reference's params over through ``models/bridge.py``)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    params = {"embed": T._table(gen, cfg, **kw),
              "dec_pos": _dec_pos(gen, cfg, **kw),
              "enc_layers": [init_enc_layer(gen, cfg, **kw)
                             for _ in range(cfg.n_enc_layers)],
              "ln_enc": T._norm(cfg, **kw)}
    params["dec_layers"] = [init_dec_layer(gen, cfg, **kw)
                            for _ in range(cfg.n_layers)]
    params["ln_f"] = T._norm(cfg, **kw)
    return params


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32,
                   device=None) -> dict:
    """``quantize_tree(init(gen, cfg, dtype, device), min_size=min_size)``
    bit for bit, each layer and the table quantized as soon as it is
    drawn under the path it has in the whole tree
    (``enc_layers.{i}.attn.wq.w``): peak memory is the int8 tree plus one
    f32 layer or table.  ``dec_pos`` stays f32 (``quantize_tree`` exempts
    it)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)

    def quantized(tree, prefix):
        return quantize_tree(tree, min_size=min_size, prefix=prefix,
                             row_chunk=T.TABLE_ROW_CHUNK)

    params = {"embed": quantized(T._table(gen, cfg, **kw), "embed"),
              "dec_pos": _dec_pos(gen, cfg, **kw),
              "enc_layers": [quantized(init_enc_layer(gen, cfg, **kw),
                                       f"enc_layers.{i}")
                             for i in range(cfg.n_enc_layers)],
              "ln_enc": T._norm(cfg, **kw)}
    params["dec_layers"] = [quantized(init_dec_layer(gen, cfg, **kw),
                                      f"dec_layers.{i}")
                            for i in range(cfg.n_layers)]
    params["ln_f"] = T._norm(cfg, **kw)
    return params


# ---------------------------------------------------------------------------
# full-sequence passes
# ---------------------------------------------------------------------------

def encode(params: dict, frame_embeds: Tensor, cfg: ArchConfig, *,
           mode: QuantMode = FP, remat: bool = True) -> Tensor:
    """frame_embeds (B, enc_seq, D), the stubbed frontend's output -> the
    encoder output (B, enc_seq, D) in its dtype.  ``remat`` is the
    reference's rematerialization for training, each layer under
    ``transformer.remat_call``."""
    mode = T.forward_mode(mode)
    b, s, d = frame_embeds.shape
    x = frame_embeds + _sinusoid(s, d, frame_embeds.device)[None].to(
        frame_embeds.dtype)
    acfg = _attn_cfg(cfg, causal=False)

    def layer(x, lp):
        h = L.layernorm(lp["ln_attn"], x)
        x = x + L.attention(lp["attn"], h, acfg, mode=mode)
        h = L.layernorm(lp["ln_mlp"], x)
        return x + L.mlp(lp["mlp"], h, gated=False, activation="gelu",
                         mode=mode)

    for lp in params["enc_layers"]:
        x = T.remat_call(remat, layer, x, lp)
    return L.layernorm(params["ln_enc"], x)


def _dec_layer(cfg: ArchConfig, mode: QuantMode, lp: dict, x: Tensor, *,
               enc_out: Optional[Tensor] = None, kv_cache=None,
               cache_index=None, valid_len=None, block_tables=None,
               cross=None) -> Tensor:
    """One decoder layer: causal self-attention (the full sequence, or
    decode against ``kv_cache``), cross-attention (over ``enc_out``, or
    the primed ``cross = (xk, xv, xlen)``), the MLP."""
    h = L.layernorm(lp["ln_self"], x)
    x = x + L.attention(lp["self_attn"], h, _attn_cfg(cfg, causal=True),
                        mode=mode, kv_cache=kv_cache,
                        cache_index=cache_index, valid_len=valid_len,
                        block_tables=block_tables)
    h = L.layernorm(lp["ln_cross"], x)
    x = x + L.attention(lp["cross_attn"], h, _attn_cfg(cfg, causal=False),
                        mode=mode, source=enc_out, cross=cross)
    h = L.layernorm(lp["ln_mlp"], x)
    return x + L.mlp(lp["mlp"], h, gated=False, activation="gelu",
                     mode=mode)


def forward(params: dict, tokens: Tensor, encoder_embeds: Tensor,
            cfg: ArchConfig, *, mode: QuantMode = FP,
            remat: bool = True) -> Tensor:
    """Teacher-forced decode over the whole target sequence (prefill, the
    service curve): tokens (B, S) and encoder_embeds (B, enc_seq, D) ->
    logits (B, S, V) f32.  Every attention runs the flash-attention
    kernel: the encoder's and the cross-attention not causal, the
    decoder's self-attention causal.  Under W8A16 every projection and
    the LM head take the tensor-core kernel.  ``remat`` checkpoints each
    encoder and each decoder layer (``transformer.remat_call``), as the
    reference's training forward does."""
    mode = T.forward_mode(mode)
    enc_out = encode(params, encoder_embeds, cfg, mode=mode, remat=remat)
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens)
    pos = torch.arange(s, device=tokens.device) % DEC_POS_TABLE
    x = x + params["dec_pos"][pos][None].to(x.dtype)

    def layer(x, lp, enc_out):
        return _dec_layer(cfg, mode, lp, x, enc_out=enc_out)

    for lp in params["dec_layers"]:
        x = T.remat_call(remat, layer, x, lp, enc_out)
    x = L.layernorm(params["ln_f"], x)
    return L.unembed(params["embed"], x, path=mode.w8a16_path)


# ---------------------------------------------------------------------------
# caches, priming and the decode step
# ---------------------------------------------------------------------------

def _cross_leaves(cfg: ArchConfig, slots: int, device) -> dict:
    """The slot-resident leaves: zero cross k/v ``xk``, ``xv`` (L, slots,
    enc_seq, KV, hd) bf16 and each row's frontier ``xlen`` (slots,) int32
    at the whole source (an unprimed batch attends its whole zero source,
    as the reference's)."""
    xshape = (cfg.n_layers, slots, cfg.enc_seq, cfg.n_kv_heads,
              cfg.head_dim)
    return {"xk": torch.zeros(xshape, dtype=torch.bfloat16, device=device),
            "xv": torch.zeros(xshape, dtype=torch.bfloat16, device=device),
            "xlen": torch.full((slots,), cfg.enc_seq, dtype=torch.int32,
                               device=device)}


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device=None) -> dict:
    """The bf16 self-attention cache k, v (L, B, S, KV, hd) and the
    slot-resident cross leaves (:func:`_cross_leaves`), zeros."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            **_cross_leaves(cfg, batch, device)}


def init_paged_cache(cfg: ArchConfig, num_slots: int, s_max: int,
                     block_size: int, num_blocks: int, device=None) -> dict:
    """The paged bf16 self-attention cache (physical blocks (L, NB, bs, KV,
    hd) behind per-slot block tables (num_slots, s_max // bs) int32); the
    cross leaves stay slot-resident (a primed row is written whole at
    admission and has no growing frontier to page)."""
    if s_max % block_size:
        raise ValueError(f"s_max={s_max} must tile into whole blocks of "
                         f"{block_size}")
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            **_cross_leaves(cfg, num_slots, device),
            "block_tables": torch.zeros((num_slots, s_max // block_size),
                                        dtype=torch.int32, device=device)}


def paged_block_axes(cache: dict) -> dict:
    """Physical-block (NB) axis of each paged leaf; xk, xv and xlen stay
    slot-resident."""
    return {"k": 1, "v": 1}


def cache_batch_axes(cache: dict) -> dict:
    """Batch (slot) axis of each cache leaf: the layer-stacked leaves keep
    it at axis 1, ``xlen`` and the block table lead with it."""
    return {k: (0 if k in ("xlen", "block_tables") else 1) for k in cache}


def _cross_kv(params: dict, enc_out: Tensor, cfg: ArchConfig, *,
              mode: QuantMode = FP) -> Tuple[Tensor, Tensor]:
    """Every decoder layer's cross k and v projected from the encoder
    output (B, Se, D): (L, B, Se, KV, hd) each, in enc_out's dtype."""
    mode = T.forward_mode(mode)
    b, se, _ = enc_out.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    xk, xv = [], []
    for lp in params["dec_layers"]:
        p = lp["cross_attn"]
        xk.append(linear(p["wk"], enc_out, mode=mode).reshape(b, se, kvh,
                                                                 hd))
        xv.append(linear(p["wv"], enc_out, mode=mode).reshape(b, se, kvh,
                                                                 hd))
    return torch.stack(xk), torch.stack(xv)


def prime_cache(params: dict, cache: dict, encoder_embeds: Tensor,
                cfg: ArchConfig, *, mode: QuantMode = FP) -> dict:
    """Run the encoder once over the whole batch and write every decoder
    layer's cross k/v into the cache in place, each row's frontier at the
    whole source."""
    enc_out = encode(params, encoder_embeds, cfg, mode=mode)
    xk, xv = _cross_kv(params, enc_out, cfg, mode=mode)
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    cache["xlen"].fill_(enc_out.shape[1])
    return cache


def prime_slot(params: dict, source: Tensor, n_valid, cfg: ArchConfig, *,
               mode: QuantMode = FP) -> dict:
    """One request's prime: encode its ``source`` (1, enc_seq, D), padded
    to the static length, and return the slot-resident leaves a prime
    dispatch writes into the slot's row — ``xk``, ``xv`` (L, 1, enc_seq,
    KV, hd) and ``xlen`` (1,) int32, ``n_valid`` (an int or a tensor of
    one value).  The encoder attends over the whole padded input
    (Whisper's pad-to-30s recipe); decode reads nothing past the
    frontier."""
    enc_out = encode(params, source, cfg, mode=mode, remat=False)
    xk, xv = _cross_kv(params, enc_out, cfg, mode=mode)
    xlen = torch.as_tensor(n_valid, dtype=torch.int32,
                           device=source.device).reshape(1)
    return {"xk": xk, "xv": xv, "xlen": xlen}


def decode_step(params: dict, tokens: Tensor, cache: dict, cache_index,
                cfg: ArchConfig, *, mode: QuantMode = FP,
                logits: bool = True, causal: bool = False
                ) -> Tuple[Optional[Tensor], dict]:
    """One decode step: tokens (B, s) -> logits (B, s, V) f32, the self
    cache written in place (see ``transformer.decode_step`` for
    ``cache_index``, ``causal``, ``logits=False`` and the paged cache).
    Each row adds its learned positions ``dec_pos[pos % 4096]`` and reads
    its primed cross k/v masked at its own ``xlen``; ``xk``, ``xv`` and
    ``xlen`` are never written.  A cache with ``slots`` (B,) (the chunk
    step's view of one slot) reads row b's slot-resident leaves at slot
    ``slots[b]``; without it row b reads slot b.  Every W8A16 matmul takes
    the GEMV, as ``transformer.decode_step``'s."""
    if mode.w8a16_path != "gemv":
        mode = dataclasses.replace(mode, w8a16_path="gemv")
    b, s = tokens.shape
    positions, valid_len, write_idx, tables = T.decode_frame(
        cache, cache_index, b, s, causal, tokens.device)
    x = L.embed(params["embed"], tokens)
    x = x + params["dec_pos"][positions.long() % DEC_POS_TABLE].to(x.dtype)
    slots = cache.get("slots")
    if slots is not None:
        slots = slots.long()
    xlen = cache["xlen"] if slots is None else cache["xlen"][slots]
    for i, lp in enumerate(params["dec_layers"]):
        xk, xv = cache["xk"][i], cache["xv"][i]
        if slots is not None:
            xk, xv = xk[slots], xv[slots]
        x = _dec_layer(cfg, mode, lp, x,
                       kv_cache=(cache["k"][i], cache["v"][i]),
                       cache_index=write_idx, valid_len=valid_len,
                       block_tables=tables, cross=(xk, xv, xlen))
    if not logits:
        return None, cache
    x = L.layernorm(params["ln_f"], x)
    return L.unembed(params["embed"], x), cache
