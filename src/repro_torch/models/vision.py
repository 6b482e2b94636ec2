"""Llama-3.2-Vision-style VLM backbone [hf:meta-llama/Llama-3.2-Vision]: the
port of ``repro/models/vision.py``.

The vision encoder is a stub, as in the reference: ``input_specs`` feeds
precomputed patch embeddings (B, n_patches, D).  The language backbone is
the dense decoder (RMSNorm, RoPE, GQA, gated MLP, an untied head) with a
*gated cross-attention* added to every ``xattn_every``-th layer: the
layer runs its self-attention and MLP as a plain layer does, then adds
``tanh(x_gate) * xattn(ln_x(x))``, the cross-attention over the patches
not causal and without RoPE, ``x_gate`` an f32 scalar initialised to
zero (the Flamingo recipe: the LM is unperturbed at init).

Serving primes each request once (:func:`prime_slot`): every cross
layer's wk / wv is projected over the request's patches, padded with zero
patches to ``n_patches`` (the projections are position-wise, so the pad
is exact), into the slot's row of the slot-resident leaves ``xk``, ``xv``
(n_groups, B, n_patches, KV, hd) bf16 with the row's frontier ``xlen``
(B,); a decode step reads them (masked at the row's own ``xlen``) and
never writes them.  The self-attention cache is bf16 whatever
``cfg.kv_quant`` says, as the reference's ``init_cache`` makes it,
contiguous or paged; only the self-attention leaves page.

Layout differences from the reference, where PyTorch idiom asks for them:
- ``params["layers"]`` is one flat list of per-layer dicts (the reference
  stacks ``groups`` of ``xattn_every - 1`` plain layers and one cross
  layer, then the ``leftover`` plain layers, for ``lax.scan``): layer
  ``i`` is a cross layer (:func:`is_cross`) when ``(i + 1) %
  xattn_every == 0`` and it lies inside the groups, and carries
  ``ln_x``, ``xattn`` and ``x_gate`` beside the plain layer's leaves;
- the self cache is one (n_layers, B, S, KV, hd) stack (paged: (n_layers,
  NB, bs, KV, hd)) in that order, written in place, so the chunk step,
  paging and the captured steps treat it as the dense family's.
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


def _xattn_cfg(cfg: ArchConfig) -> L.AttnConfig:
    return L.AttnConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, causal=False, use_rope=False)


def n_groups(cfg: ArchConfig) -> int:
    """How many groups of ``xattn_every`` layers, each ending in a cross
    layer; the ``n_layers % xattn_every`` layers after them are plain."""
    return cfg.n_layers // cfg.xattn_every


def is_cross(cfg: ArchConfig, i: int) -> bool:
    """True when layer ``i`` is a group's last layer, a cross layer."""
    return (i + 1) % cfg.xattn_every == 0 and i < n_groups(cfg) * \
        cfg.xattn_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_xattn_layer(gen, cfg: ArchConfig, dtype, device) -> dict:
    """A plain layer plus ``ln_x``, the cross-attention's projections (no
    bias) and the zero gate ``x_gate``."""
    p = T.init_layer(gen, cfg, dtype, device)
    p["ln_x"] = T._norm(cfg, dtype, device)
    p["xattn"] = T.init_attention(gen, dataclasses.replace(
        cfg, qkv_bias=False), dtype, device)
    p["x_gate"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def _layer_init(cfg: ArchConfig, i: int):
    return init_xattn_layer if is_cross(cfg, i) else T.init_layer


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None) -> dict:
    """Random params from ``gen``: the embedding table, layers 0 to L-1
    (each cross layer with its cross-attention), ``ln_f``, the untied
    head.  Same distributions as the reference's ``init``, other numbers
    (tests copy the reference's params over through ``models/bridge.py``)."""
    device = resolve_device(device)
    params = {"embed": T._table(gen, cfg, dtype, device),
              "layers": [_layer_init(cfg, i)(gen, cfg, dtype, device)
                         for i in range(cfg.n_layers)],
              "ln_f": T._norm(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = T._table(gen, cfg, dtype, device)
    return params


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32,
                   device=None) -> dict:
    """``quantize_tree(init(gen, cfg, dtype, device), min_size=min_size)``
    bit for bit, each layer and table quantized as soon as it is drawn
    under the path it has in the whole tree (``layers.{i}.xattn.wq.w``):
    peak memory is the int8 tree plus one f32 layer or table.  ``x_gate``
    and the norms stay f32."""
    device = resolve_device(device)

    def quantized(tree, prefix):
        return quantize_tree(tree, min_size=min_size, prefix=prefix,
                             row_chunk=T.TABLE_ROW_CHUNK)

    params = {"embed": quantized(T._table(gen, cfg, dtype, device), "embed"),
              "layers": [quantized(_layer_init(cfg, i)(gen, cfg, dtype,
                                                       device), f"layers.{i}")
                         for i in range(cfg.n_layers)],
              "ln_f": T._norm(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = quantized(T._table(gen, cfg, dtype, device),
                                      "unembed")
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _gated(lp: dict, x: Tensor, a: Tensor) -> Tensor:
    """x + tanh(x_gate) * a, the product in f32 and cast to x's dtype."""
    return x + (torch.tanh(lp["x_gate"]) * a.float()).to(x.dtype)


def forward(params: dict, tokens: Tensor, vision_embeds: Tensor,
            cfg: ArchConfig, *, mode: QuantMode = FP,
            remat: bool = True) -> Tensor:
    """Full-sequence forward (prefill, the service curve): tokens (B, S)
    and vision_embeds (B, n_patches, D) -> logits (B, S, V) f32.  Every
    attention runs the flash-attention kernel: the self-attention causal,
    the cross-attention over the patches not causal.  Under W8A16 every
    projection and the LM head take the tensor-core kernel.  ``remat`` is
    the reference's training switch; it has no effect here."""
    mode = T.forward_mode(mode)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    acfg, xcfg = T.attn_config(cfg), _xattn_cfg(cfg)
    x = L.embed(params["embed"], tokens)
    for lp in params["layers"]:
        h = T.norm_apply(cfg, lp["ln_attn"], x)
        x = x + L.attention(lp["attn"], h, acfg, mode=mode, rope=rope)
        h = T.norm_apply(cfg, lp["ln_mlp"], x)
        x = x + T.dense_ffn(lp, h, cfg, mode=mode)
        if "xattn" in lp:
            h = T.norm_apply(cfg, lp["ln_x"], x)
            x = _gated(lp, x, L.attention(lp["xattn"], h, xcfg, mode=mode,
                                          source=vision_embeds))
    x = T.norm_apply(cfg, params["ln_f"], x)
    head = params.get("unembed", params["embed"])
    return L.unembed(head, x, path=mode.w8a16_path)


# ---------------------------------------------------------------------------
# caches, priming and the decode step
# ---------------------------------------------------------------------------

def _cross_leaves(cfg: ArchConfig, slots: int, device) -> dict:
    """The slot-resident leaves: zero cross k/v ``xk``, ``xv`` (n_groups,
    slots, n_patches, KV, hd) bf16 and each row's frontier ``xlen``
    (slots,) int32 at every patch (an unprimed batch attends its whole
    zero source, as the reference's)."""
    xshape = (n_groups(cfg), slots, cfg.n_patches, cfg.n_kv_heads,
              cfg.head_dim)
    return {"xk": torch.zeros(xshape, dtype=torch.bfloat16, device=device),
            "xv": torch.zeros(xshape, dtype=torch.bfloat16, device=device),
            "xlen": torch.full((slots,), cfg.n_patches, dtype=torch.int32,
                               device=device)}


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device=None) -> dict:
    """The bf16 self-attention cache k, v (n_layers, B, S, KV, hd) and the
    slot-resident cross leaves (:func:`_cross_leaves`), zeros."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            **_cross_leaves(cfg, batch, device)}


def init_paged_cache(cfg: ArchConfig, num_slots: int, s_max: int,
                     block_size: int, num_blocks: int, device=None) -> dict:
    """The paged bf16 self-attention cache: physical blocks (n_layers, NB,
    bs, KV, hd) of every layer, cross or plain, behind one per-slot block
    table (num_slots, s_max // bs) int32; the cross leaves stay
    slot-resident (a primed row is written whole at admission and has no
    growing frontier to page)."""
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
    """Batch (slot) axis of each cache leaf: the layer- and group-stacked
    leaves keep it at axis 1, ``xlen`` and the block table lead with it."""
    return {k: (0 if k in ("xlen", "block_tables") else 1) for k in cache}


def _cross_kv(params: dict, vision_embeds: Tensor, cfg: ArchConfig, *,
              mode: QuantMode = FP) -> Tuple[Tensor, Tensor]:
    """Every cross layer's k and v projected from the patch embeddings
    (B, P, D), on the tensor-core W8A16 kernel: (n_groups, B, P, KV, hd)
    each."""
    mode = T.forward_mode(mode)
    b, npatch, _ = vision_embeds.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    xk, xv = [], []
    for lp in params["layers"]:
        if "xattn" in lp:
            p = lp["xattn"]
            xk.append(linear(p["wk"], vision_embeds, mode=mode).reshape(
                b, npatch, kvh, hd))
            xv.append(linear(p["wv"], vision_embeds, mode=mode).reshape(
                b, npatch, kvh, hd))
    return torch.stack(xk), torch.stack(xv)


def prime_cache(params: dict, cache: dict, vision_embeds: Tensor,
                cfg: ArchConfig, *, mode: QuantMode = FP) -> dict:
    """Project every cross layer's k/v over the whole batch's patches and
    write them into the cache in place, each row's frontier at every
    patch."""
    xk, xv = _cross_kv(params, vision_embeds, cfg, mode=mode)
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    cache["xlen"].fill_(vision_embeds.shape[1])
    return cache


def prime_slot(params: dict, source: Tensor, n_valid, cfg: ArchConfig, *,
               mode: QuantMode = FP) -> dict:
    """One request's prime: project its patch embeddings ``source`` (1,
    n_patches, D), padded with zero patches to the static count, and
    return the slot-resident leaves a prime dispatch writes into the
    slot's row — ``xk``, ``xv`` (n_groups, 1, n_patches, KV, hd) and
    ``xlen`` (1,) int32, ``n_valid`` (an int or a tensor of one value);
    decode reads nothing past the frontier."""
    xk, xv = _cross_kv(params, source, cfg, mode=mode)
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
    Each cross layer reads its group's primed cross k/v masked at the
    row's own ``xlen``; ``xk``, ``xv`` and ``xlen`` are never written.  A
    cache with ``slots`` (B,) (the chunk step's view of one slot) reads
    row b's slot-resident leaves at slot ``slots[b]``; without it row b
    reads slot b.  Every W8A16 matmul takes the GEMV, as
    ``transformer.decode_step``'s."""
    if mode.w8a16_path != "gemv":
        mode = dataclasses.replace(mode, w8a16_path="gemv")
    b, s = tokens.shape
    positions, valid_len, write_idx, tables = T.decode_frame(
        cache, cache_index, b, s, causal, tokens.device)
    acfg, xcfg = T.attn_config(cfg), _xattn_cfg(cfg)
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = L.embed(params["embed"], tokens)
    slots = cache.get("slots")
    if slots is not None:
        slots = slots.long()
    xlen = cache["xlen"] if slots is None else cache["xlen"][slots]
    group = 0
    for i, lp in enumerate(params["layers"]):
        h = T.norm_apply(cfg, lp["ln_attn"], x)
        x = x + L.attention(lp["attn"], h, acfg, mode=mode, rope=rope,
                            kv_cache=(cache["k"][i], cache["v"][i]),
                            cache_index=write_idx, valid_len=valid_len,
                            block_tables=tables)
        h = T.norm_apply(cfg, lp["ln_mlp"], x)
        x = x + T.dense_ffn(lp, h, cfg, mode=mode)
        if "xattn" in lp:
            xk, xv = cache["xk"][group], cache["xv"][group]
            if slots is not None:
                xk, xv = xk[slots], xv[slots]
            h = T.norm_apply(cfg, lp["ln_x"], x)
            x = _gated(lp, x, L.attention(lp["xattn"], h, xcfg, mode=mode,
                                          cross=(xk, xv, xlen)))
            group += 1
    if not logits:
        return None, cache
    x = T.norm_apply(cfg, params["ln_f"], x)
    head = params.get("unembed", params["embed"])
    return L.unembed(head, x), cache
