"""Dense decoder-only LM (starcoder2, mistral-nemo, internlm2, qwen1.5):
the full-sequence forward and the decode step.  The MoE configs
(qwen2-moe, mixtral) run the same loops (``models/moe.py``).

Structure: embedding -> a loop over decoder layers -> final norm -> (tied
or untied) unembed.  One decoder layer = norm (LayerNorm or RMSNorm) ->
GQA attention -> residual -> norm -> MLP (plain or gated) -> residual.
Quantization mode threads through every matmul.  The MoE family
(``models/moe.py``) is the same model with another FFN: ``init``,
``init_quantized``, ``forward`` and ``decode_step`` take the layer's
init and FFN as functions (``layer=``, ``ffn=``; the dense ones by
default).

Layout differences from ``repro/models/transformer.py``, where PyTorch
idiom asks for them:
- ``params["layers"]`` is a list of per-layer dicts (the reference stacks
  them on a leading L axis for ``lax.scan``);
- the KV cache keeps the reference's stacked (L, B, S, KV, hd) leaves,
  int8 with f32 scales or bf16, and ``decode_step`` writes them in
  place.  The reference's switch between an in-scan cache update and an
  append after the scan
  (``n_kv_heads >= 16``, ``transformer.py:219``) is a choice about
  functional updates; with in-place writes the port always writes first
  and then attends (the non-append form).  The paged cache follows the
  same rule: the new token's entry is written into its physical block
  before the kernel reads the row through its table (the reference
  attends with the append column and scatters after the scan).

A windowed config (mixtral's 4,096) keeps a ring of ``min(s_max,
window)`` slots, as the reference's ``init_cache``: position p is
written at slot ``p % s_alloc`` (RoPE at the absolute position, so the
ring's order does not matter to the scores) and a row reads the slots
below ``min(p + 1, s_alloc)``; once the ring is full every slot is
valid, and position p attends p and the ``window - 1`` positions before
it, the full-sequence forward's sliding-window mask.  Paging and
speculation refuse a window (``registry.py``), and a ring's chunk runs
token by token (``registry.decodes_chunk_in_one_pass``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.core.quant import quantize_tree
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

Tensor = torch.Tensor


def attn_config(cfg: ArchConfig) -> L.AttnConfig:
    return L.AttnConfig(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        window=cfg.window)


def norm_apply(cfg: ArchConfig, p, x):
    return (L.layernorm if cfg.norm == "layernorm" else L.rmsnorm)(p, x)


def forward_mode(mode: QuantMode) -> QuantMode:
    """The mode of a full-sequence pass (``forward``; encdec's ``encode``
    and the primed families' cross k/v projection): under W8A16 every
    projection takes the tensor-core kernel (``w8a16_path="mma"``)."""
    if mode.enabled and not mode.w8a8:
        return dataclasses.replace(mode, w8a16_path="mma")
    return mode


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _linear(gen, d_in, d_out, *, bias, dtype, device, scale=None) -> dict:
    """Truncated-normal init in [-2, 2] std units, std = 1/sqrt(d_in)
    unless overridden (the reference's ``init_linear``)."""
    std = scale if scale is not None else d_in ** -0.5
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    p = {"w": (w * std).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def _norm(cfg: ArchConfig, dtype, device) -> dict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def init_mlp(gen, d: int, f: int, *, gated: bool, dtype, device) -> dict:
    """A (gated) MLP of width ``f`` (the reference's ``L.init_mlp``)."""
    kw = dict(dtype=dtype, device=device)
    mlp = {"w_up": _linear(gen, d, f, bias=False, **kw),
           "w_down": _linear(gen, f, d, bias=False, scale=f ** -0.5, **kw)}
    if gated:
        mlp["w_gate"] = _linear(gen, d, f, bias=False, **kw)
    return mlp


def init_attention(gen, cfg: ArchConfig, dtype, device) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {"wq": _linear(gen, d, h * hd, bias=cfg.qkv_bias, **kw),
            "wk": _linear(gen, d, kvh * hd, bias=cfg.qkv_bias, **kw),
            "wv": _linear(gen, d, kvh * hd, bias=cfg.qkv_bias, **kw),
            "wo": _linear(gen, h * hd, d, bias=False,
                          scale=(h * hd) ** -0.5, **kw)}


def init_layer(gen, cfg: ArchConfig, dtype, device) -> dict:
    mlp = init_mlp(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                   dtype=dtype, device=device)
    return {"ln_attn": _norm(cfg, dtype, device),
            "attn": init_attention(gen, cfg, dtype, device),
            "ln_mlp": _norm(cfg, dtype, device), "mlp": mlp}


def _table(gen, cfg: ArchConfig, dtype, device) -> dict:
    """A (V, D) embedding table, N(0, 1/D)."""
    t = torch.empty((cfg.vocab, cfg.d_model), dtype=torch.float32,
                    device=device)
    t.normal_(generator=gen)
    return {"table": t.mul_(cfg.d_model ** -0.5).to(dtype)}


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None, *, layer=init_layer) -> dict:
    """Random params from ``gen`` (its device must be ``device``'s type),
    each decoder layer drawn by ``layer``.  Same distributions as the
    reference's ``init``, other numbers: tests that compare with the
    reference copy its params over instead (``models/bridge.py``)."""
    device = resolve_device(device)
    params = {"embed": _table(gen, cfg, dtype, device),
              "layers": [layer(gen, cfg, dtype, device)
                         for _ in range(cfg.n_layers)],
              "ln_f": _norm(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = _table(gen, cfg, dtype, device)
    return params


# rows of a table quantized at a time by init_quantized (f32 temporaries
# of 8,192 x d_model, 0.2 GB at d = 6,144)
TABLE_ROW_CHUNK = 8192


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32,
                   device=None, layer=init_layer) -> dict:
    """``quantize_tree(init(gen, cfg, dtype, device), min_size=min_size)``,
    bit for bit, without the whole f32 tree: the draws come in ``init``'s
    order (the embedding table, layers 0 to L-1, ``ln_f``, the unembedding
    table) and each layer's subtree and each table is quantized as soon
    as it is drawn, under the path it has in the whole tree
    (``layers.{i}.attn.wq.w``, ``embed.table``), so the same leaves are
    quantized.  Peak memory is the int8 tree plus one f32 layer or one f32
    table (quantized TABLE_ROW_CHUNK rows at a time): full-width
    qwen1.5-32b's 35 GB of int8 weights come from a tree of 141 GB in
    f32."""
    device = resolve_device(device)

    def quantized(tree, prefix):
        return quantize_tree(tree, min_size=min_size, prefix=prefix,
                             row_chunk=TABLE_ROW_CHUNK)

    params = {"embed": quantized(_table(gen, cfg, dtype, device), "embed"),
              "layers": []}
    for i in range(cfg.n_layers):
        params["layers"].append(
            quantized(layer(gen, cfg, dtype, device), f"layers.{i}"))
    params["ln_f"] = _norm(cfg, dtype, device)      # 1-D: never quantized
    if not cfg.tie_embeddings:
        params["unembed"] = quantized(_table(gen, cfg, dtype, device),
                                      "unembed")
    return params


def draft_params(params: dict, n_layers: int) -> dict:
    """The truncated-layer *self-draft* view: the first ``n_layers``
    layers, with the embedding, the final norm and the (tied) head the
    target's own objects.  A shared view, no copy: the layer list is a
    new list over the same layer dicts, so every tensor (int8 values and
    scales alike) is the target's.  At ``n_layers == cfg.n_layers`` the
    draft computes what the target computes."""
    return dict(params, layers=params["layers"][:n_layers])


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _records_grad(tree) -> bool:
    """True when a tensor of ``tree`` (a layer's params) requires grad."""
    if isinstance(tree, dict):
        return any(_records_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat_call(remat: bool, fn, x: Tensor, weights, *extra):
    """``fn(x, weights, *extra)``, the reference's ``jax.checkpoint`` with
    ``nothing_saveable`` where ``remat`` is on and autograd records the
    call (grad enabled and a tensor of ``weights`` requiring grad): it
    runs under ``torch.utils.checkpoint`` (non-reentrant) and keeps only
    its inputs, so its activations are recomputed in the backward pass;
    the values are the same either way.  Serving and captured forwards
    never checkpoint."""
    if remat and torch.is_grad_enabled() and _records_grad(weights):
        return checkpoint(fn, x, weights, *extra, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(x, weights, *extra)


def dense_ffn(lp: dict, h: Tensor, cfg: ArchConfig, *, mode: QuantMode,
              per_token: bool = False) -> Tensor:
    """The dense layer's FFN, ``lp["mlp"]``.  ``per_token`` (the tokens of
    a row are to be taken one at a time, as the per-token chunk step
    would) changes nothing here: every row of the MLP is computed on its
    own."""
    return L.mlp(lp["mlp"], h, gated=cfg.gated_mlp,
                 activation=cfg.activation, mode=mode)


def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            mode: QuantMode = FP, remat: bool = True,
            ffn=dense_ffn) -> Tensor:
    """Full-sequence forward (prefill): tokens (B, S) -> logits (B, S, V)
    f32.  Every attention layer runs the flash-attention kernel, causal
    (and windowed for a windowed config).  Under W8A16 every projection
    and the LM head take the tensor-core kernel (``w8a16_path="mma"``):
    this forward's rows need not match a decode step's bits.  ``remat``
    is the reference's rematerialization for training, each layer under
    :func:`remat_call`: its activations (and the f32 copies of its
    bf16-rounded weights, ``core/qlinear.py``) are recomputed in the
    backward pass.  ``ffn(lp, h, cfg, mode=...)`` is each layer's FFN."""
    mode = forward_mode(mode)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    acfg = attn_config(cfg)

    def layer(x, lp):
        h = norm_apply(cfg, lp["ln_attn"], x)
        x = x + L.attention(lp["attn"], h, acfg, mode=mode, rope=rope)
        h = norm_apply(cfg, lp["ln_mlp"], x)
        return x + ffn(lp, h, cfg, mode=mode)

    x = L.embed(params["embed"], tokens)
    for lp in params["layers"]:
        x = remat_call(remat, layer, x, lp)
    x = norm_apply(cfg, params["ln_f"], x)
    head = params.get("unembed", params["embed"])
    return L.unembed(head, x, path=mode.w8a16_path)


# ---------------------------------------------------------------------------
# cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device=None) -> dict:
    """Stacked (L, B, S, KV, hd) KV cache: with ``cfg.kv_quant`` int8 with
    per-(token, head) f32 scales shaped (L, B, S, KV, 1), else bf16 k and
    v.  S is ``s_max``, or for a windowed config the ring's ``min(s_max,
    cfg.window)`` slots."""
    device = resolve_device(device)
    s_alloc = min(s_max, cfg.window) if cfg.window else s_max
    shape = (cfg.n_layers, batch, s_alloc, cfg.n_kv_heads, cfg.head_dim)
    if not cfg.kv_quant:       # L * B rows of one layer's form, viewed as L
        k, v = L.init_kv_cache(cfg.n_layers * batch, s_alloc,
                               cfg.n_kv_heads, cfg.head_dim, device=device)
        return {"k": k.reshape(shape), "v": v.reshape(shape)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device)}


def init_paged_cache(cfg: ArchConfig, num_slots: int, s_max: int,
                     block_size: int, num_blocks: int, device=None) -> dict:
    """Paged KV cache: physical blocks (L, NB, bs, KV, hd), with
    ``cfg.kv_quant`` int8 with f32 scales (L, NB, bs, KV, 1), else bf16 k
    and v, plus a per-slot block table (num_slots, s_max // bs) int32.
    Block 0 is the reserved trash block every unallocated entry points
    at.  Only full attention pages (a window's ring overwrite has no
    stable position to map through a table)."""
    if cfg.window:
        raise ValueError("paged KV cache requires full attention "
                         f"(window=None), got window={cfg.window}")
    if s_max % block_size:
        raise ValueError(f"s_max={s_max} must tile into whole blocks of "
                         f"{block_size}")
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    tables = torch.zeros((num_slots, s_max // block_size), dtype=torch.int32,
                         device=device)
    if not cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "block_tables": tables}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                   device=device),
            "block_tables": tables}


def paged_block_axes(cache: dict) -> dict:
    """Physical-block (NB) axis of each paged cache leaf."""
    return {k: 1 for k in cache if k != "block_tables"}


def decode_positions(cache_index, b: int, s: int, device) -> Tensor:
    """(B, s) int32 positions of ``s`` tokens written from ``cache_index``
    on: an int (every row at the same place) or a (B,) tensor (each row at
    its own), plus ``arange(s)``, as the reference's ``decode_step``
    computes them.  One kernel for the int form, none for one token of
    the tensor form (the slot tick's)."""
    if isinstance(cache_index, int):
        return torch.arange(cache_index, cache_index + s, dtype=torch.int32,
                            device=device).expand(b, s)
    rows = cache_index.reshape(b, 1).int()
    if s == 1:
        return rows
    return rows + torch.arange(s, dtype=torch.int32, device=device)


def decode_frame(cache: dict, cache_index, b: int, s: int, causal: bool,
                 device, *, ring: bool = False):
    """Where ``s`` tokens of ``b`` rows written from ``cache_index`` go in
    a (paged) KV cache with leaves ``k`` (L, B, S, ...) or (L, NB, bs,
    ...): ``(positions, valid_len, write_idx, tables)`` — the (B, s)
    positions (:func:`decode_positions`), each query row's frontier ((B,),
    or (B, s) when ``causal`` and s > 1), the places to write (an int, or
    index tensors for :func:`layers.cache_write`) and the cache's
    ``block_tables`` or None (see :func:`decode_step`).

    With ``ring`` (a windowed config) the cache's S slots are a ring: a
    row's s tokens are written from slot ``cache_index % S`` on, that
    start clamped to ``S - s`` as the reference's ``dynamic_update_slice``
    clamps it (s > 1 across the ring's end; one token never crosses it).
    A ring takes no causal pass of s > 1: its last token's write would
    overwrite a slot its first token still reads."""
    tables = cache.get("block_tables")
    if tables is not None:
        bs = cache["k"].shape[2]
        s_alloc = tables.shape[1] * bs
    else:
        s_alloc = cache["k"].shape[2]
    if ring and causal and s > 1:
        raise ValueError(
            f"a ring's {s} tokens cannot take one causal pass: their "
            f"writes precede every read (feed a windowed chunk one token "
            f"per call)")
    positions = decode_positions(cache_index, b, s, device)
    places = positions
    if isinstance(cache_index, int):
        valid_len = torch.full((b,), min(cache_index + s, s_alloc),
                               dtype=torch.int32, device=device)
        write_idx = cache_index
        if ring:
            write_idx = min(cache_index % s_alloc, s_alloc - s)
            places = decode_positions(write_idx, b, s, device)
    else:
        valid_len = torch.clamp_max(cache_index.reshape(b).int() + s,
                                    s_alloc)
        if ring:
            start = cache_index.reshape(b).int() % s_alloc
            places = decode_positions(
                start if s == 1 else torch.clamp_max(start, s_alloc - s),
                b, s, device)
        write_idx = (torch.arange(b, device=device)[:, None],
                     places.long())
    if causal and s > 1:
        valid_len = torch.clamp_max(positions + 1, s_alloc)
    if tables is not None:
        pos = places.long()
        rows = torch.arange(b, device=device)[:, None]
        write_idx = (tables[rows, pos // bs].long(), pos % bs)
    return positions, valid_len, write_idx, tables


def decode_step(params: dict, tokens: Tensor, cache: dict, cache_index,
                cfg: ArchConfig, *, mode: QuantMode = FP,
                logits: bool = True, causal: bool = False, ffn=dense_ffn
                ) -> Tuple[Optional[Tensor], dict]:
    """One decode step: tokens (B, s) -> logits (B, s, V) f32, with the
    cache updated in place (and returned, for the reference's signature).

    ``cache_index`` is an int when the whole batch advances in lockstep,
    or a (B,) int tensor when every row is an independent request at its
    own position (the slot engine, and the captured decode loop with
    every row at one place: the two forms give the same bits).  Token j
    sits at ``cache_index + j`` (:func:`decode_positions`) and is written
    there, every token's k/v before any attends.  Token j then attends
    the slots below ``cache_index + s``, the reference's form; with
    ``causal=True`` it attends those below its own ``cache_index + j +
    1``, as the one-token step at its place does (the chunk step's one
    pass, ``runtime/steps.py``), and each layer's ``ffn`` takes the s
    tokens of a row one at a time (``per_token``: an MoE layer routes
    each alone, as the one-token step does).  ``logits=False`` skips the
    final norm and LM head (chunked prefill discards them) and returns
    None.

    A cache with ``block_tables`` (B, MB) is paged (:func:`init_paged_cache`
    with the slots' tables, or rows of them; or a contiguous cache's
    (L, B, S, ...) leaves read as B blocks of S slots, with (B, 1) slot
    ids as the table): row b's position p is written to block
    ``block_tables[b, p // bs]`` at offset ``p % bs``, and attention
    reads the row through its table.

    Every W8A16 matmul takes the GEMV (``w8a16_path="gemv"``), whatever
    the mode asks: a row's bits then do not depend on the batch, which
    the engine's parity with its batch-1 reference needs.

    A windowed config's cache is a ring (:func:`init_cache`): token j is
    written at slot ``(cache_index + j) % S`` (:func:`decode_frame`) and
    attends the slots below ``min(cache_index + s, S)``, the reference's
    frontier; ``causal=True`` with s > 1 raises there."""
    if mode.w8a16_path != "gemv":
        mode = dataclasses.replace(mode, w8a16_path="gemv")
    b, s = tokens.shape
    positions, valid_len, write_idx, tables = decode_frame(
        cache, cache_index, b, s, causal, tokens.device,
        ring=cfg.window is not None)
    acfg = attn_config(cfg)
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = L.embed(params["embed"], tokens)
    leaves = (("k", "v", "k_scale", "v_scale") if "k_scale" in cache
              else ("k", "v"))
    for i, lp in enumerate(params["layers"]):
        kv = tuple(cache[name][i] for name in leaves)
        h = norm_apply(cfg, lp["ln_attn"], x)
        x = x + L.attention(lp["attn"], h, acfg, mode=mode, rope=rope,
                            kv_cache=kv, cache_index=write_idx,
                            valid_len=valid_len, block_tables=tables)
        h = norm_apply(cfg, lp["ln_mlp"], x)
        x = x + ffn(lp, h, cfg, mode=mode, per_token=causal and s > 1)
    if not logits:
        return None, cache
    x = norm_apply(cfg, params["ln_f"], x)
    head = params.get("unembed", params["embed"])
    return L.unembed(head, x), cache
