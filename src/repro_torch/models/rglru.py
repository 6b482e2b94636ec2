"""RecurrentGemma / Griffin hybrid [arXiv:2402.19427]: the port of
``repro/models/rglru.py``.

Layer pattern: (rec, rec, attn) repeating — two RG-LRU recurrent blocks per
local-attention block (window ``local_window``, MQA), then up to two
leftover recurrent blocks.  Every block is norm -> temporal mixing ->
residual; norm -> gated MLP -> residual.

Recurrent block: two branches from x —
  a: linear(D->W) -> causal conv1d(width) -> RG-LRU
  b: linear(D->W) -> GeLU
merged a*b -> linear(W->D).

RG-LRU:  r_t = sigmoid(W_a x + b_a)        (recurrence gate)
         i_t = sigmoid(W_x x + b_x)        (input gate)
         log a_t = -c * softplus(Lambda) * r_t          (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence ``forward`` (prefill, the service curve) evaluates the
linear recurrence by a doubling (Hillis-Steele) scan, log2 S passes of
plain PyTorch, where the reference runs ``jax.lax.associative_scan``; its
attention blocks run the flash-attention kernel with the window.
``decode_step`` is the O(1) state update and one token of ring attention.
The state and the gates are f32; the projections run through ``linear``
like every other matmul.  The reference has no kernel for the scan, the
state update or the ring's decode attention (a bf16 ring, whatever
``kv_quant`` says), so they are plain PyTorch here.

Serving state (``init_cache``), the reference's leaves: ``rnn_h`` (G, 2, B,
W) f32 and ``conv`` (G, 2, B, width - 1, W) bf16 for the groups' two
recurrent blocks, ``lo_rnn_h`` (lo, B, W) and ``lo_conv`` for the
leftover ones, and the local-attention ring ``k``, ``v`` (G, B, win, KV,
hd) bf16 with ``win = min(local_window, s_max)``.  A row at position p
writes its k/v at ring slot ``p % win`` (RoPE at the absolute position p,
so the ring's order does not matter to the scores) and reads the slots
below ``min(p + 1, win)``.  The slot contract as in ``models/ssm.py``: a
row decoding position 0 zeroes its recurrent state and conv tails first
(the scrub), and a row the tick does not advance keeps them bitwise (the
freeze: ``where(active, new, old)`` written in place, block by block).
The ring needs no freeze: an inactive row writes its k/v at its frozen
``p % win``, the one slot its next real step overwrites before any read
(it holds position p - win, which has just left the window).

Layout differences from the reference, as in ``models/transformer.py``:
``params["groups"]`` is a list of per-group dicts ``{rec0, rec1, attn}``
and ``params["leftover"]`` a list of recurrent blocks (the reference
stacks both for ``lax.scan``), and the cache is written in place.
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
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Tensor = torch.Tensor
_C = 8.0   # RG-LRU decay sharpness constant


# ---------------------------------------------------------------------------
# layout and init
# ---------------------------------------------------------------------------

def _layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(groups of (rec, rec, attn), leftover rec blocks)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    if tuple(pat) != ("rec", "rec", "attn"):
        raise ValueError("only the Griffin 2:1 pattern is implemented")
    n_groups = cfg.n_layers // 3
    leftover = cfg.n_layers - 3 * n_groups
    return n_groups, leftover


def _attn_cfg(cfg: ArchConfig) -> L.AttnConfig:
    return L.AttnConfig(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                        window=cfg.local_window)


def init_rglru(gen, width: int, device) -> dict:
    """The gates' (W, W) f32 linears with biases, whatever the dtype of
    the rest (the reference's ``init_rglru``), and ``Lambda`` spanning
    a^c in about [0.9, 0.999]."""
    kw = dict(dtype=torch.float32, device=device)
    return {"w_a": T._linear(gen, width, width, bias=True, **kw),
            "w_x": T._linear(gen, width, width, bias=True, **kw),
            "Lambda": torch.linspace(-4.3, -1.5, width, **kw)}


def init_rec_block(gen, cfg: ArchConfig, dtype, device) -> dict:
    d, w = cfg.d_model, cfg.rnn_width or cfg.d_model
    kw = dict(dtype=dtype, device=device)
    w_in_a = T._linear(gen, d, w, bias=False, **kw)
    w_in_b = T._linear(gen, d, w, bias=False, **kw)
    conv_w = torch.empty((cfg.conv_width, w), dtype=torch.float32,
                         device=device)
    torch.nn.init.trunc_normal_(conv_w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    lru = init_rglru(gen, w, device)
    w_out = T._linear(gen, w, d, bias=False, scale=w ** -0.5, **kw)
    return {"ln": T._norm(cfg, **kw), "w_in_a": w_in_a, "w_in_b": w_in_b,
            "conv_w": (conv_w * 0.3).to(dtype),
            "conv_b": torch.zeros((w,), **kw), "lru": lru, "w_out": w_out,
            "ln_mlp": T._norm(cfg, **kw),
            "mlp": T.init_mlp(gen, d, cfg.d_ff, gated=cfg.gated_mlp, **kw)}


def init_attn_block(gen, cfg: ArchConfig, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    attn = T.init_attention(gen, cfg, **kw)
    return {"ln": T._norm(cfg, **kw), "attn": attn,
            "ln_mlp": T._norm(cfg, **kw),
            "mlp": T.init_mlp(gen, cfg.d_model, cfg.d_ff,
                              gated=cfg.gated_mlp, **kw)}


def init_group(gen, cfg: ArchConfig, dtype, device) -> dict:
    return {"rec0": init_rec_block(gen, cfg, dtype, device),
            "rec1": init_rec_block(gen, cfg, dtype, device),
            "attn": init_attn_block(gen, cfg, dtype, device)}


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None) -> dict:
    """Random params from ``gen`` in this order: the tied embedding table,
    the groups, the leftover blocks (the final norm draws nothing); the
    reference's distributions, other numbers (tests copy the reference's
    params over through ``models/bridge.py``)."""
    device = resolve_device(device)
    n_groups, leftover = _layout(cfg)
    kw = dict(dtype=dtype, device=device)
    params = {"embed": T._table(gen, cfg, **kw),
              "groups": [init_group(gen, cfg, **kw) for _ in range(n_groups)],
              "ln_f": T._norm(cfg, **kw)}
    if leftover:
        params["leftover"] = [init_rec_block(gen, cfg, **kw)
                              for _ in range(leftover)]
    return params


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32,
                   device=None) -> dict:
    """``quantize_tree(init(gen, cfg, dtype, device), min_size=min_size)``
    bit for bit, the table, each group and each leftover block quantized
    as soon as it is drawn under its path in the whole tree
    (``groups.{i}.rec0.lru.w_a.w``): peak memory is the int8 tree plus
    the f32 table (4.19 GB at full width) or one f32 group.  The
    quantizer's path rule takes every ``.w`` — the gates' f32 ``lru.w_a.w``
    and ``lru.w_x.w`` too — and the table; ``conv_w``, ``Lambda``, the
    biases and the norms stay f32, as the reference's ``quantize_tree``
    leaves them."""
    device = resolve_device(device)
    n_groups, leftover = _layout(cfg)
    kw = dict(dtype=dtype, device=device)

    def quantized(tree, prefix):
        return quantize_tree(tree, min_size=min_size, prefix=prefix,
                             row_chunk=T.TABLE_ROW_CHUNK)

    params = {"embed": quantized(T._table(gen, cfg, **kw), "embed"),
              "groups": [quantized(init_group(gen, cfg, **kw), f"groups.{i}")
                         for i in range(n_groups)],
              "ln_f": T._norm(cfg, **kw)}
    if leftover:
        params["leftover"] = [
            quantized(init_rec_block(gen, cfg, **kw), f"leftover.{i}")
            for i in range(leftover)]
    return params


# ---------------------------------------------------------------------------
# the RG-LRU and the blocks
# ---------------------------------------------------------------------------

def sigmoid(x: Tensor) -> Tensor:
    """``jax.nn.sigmoid`` of a bf16 x as the jitted reference computes it
    (XLA's expansion): 1 / (1 + exp(-x)) with the exponential and the sum
    rounded to x's dtype and the quotient left f32 (its rounding falls
    away where the next op widens it).  ``torch.sigmoid`` rounds once, a
    bf16 ulp apart on a third of the inputs.  Out f32."""
    e = torch.exp(-x.float()).to(x.dtype).float()
    return 1.0 / (e + 1.0).to(x.dtype).float()


def _rglru_gates(p: dict, x: Tensor, mode: QuantMode) -> Tuple[Tensor, Tensor]:
    """(a, b) of h_t = a_t h_{t-1} + b_t, f32, for x (B, S, W).  The
    reference runs the gates with ``mode=FP`` on int8 weights, which is
    W8A16 whatever the caller's mode (W8A8 too); their outputs take x's
    dtype (bf16) before the sigmoid (:func:`sigmoid`)."""
    gate = dataclasses.replace(mode, act_bits=16)
    r = sigmoid(linear(p["w_a"], x, mode=gate, compute_dtype=torch.float32))
    i = sigmoid(linear(p["w_x"], x, mode=gate, compute_dtype=torch.float32))
    a = torch.exp(-_C * S.softplus(p["Lambda"]) * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.float())
    return a, b


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over dim 1, by doubling: at
    offset d every element t >= d takes in the segment ending at t - d,
    (a, b) <- (a_{t-d} a_t, b_{t-d} a_t + b_t), log2 S passes."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru(p: dict, x: Tensor, *, mode: QuantMode = FP,
          state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """x (B, S, W) -> (y in x's dtype, the last state (B, W) f32);
    ``state`` (B, W) steps one token (S == 1) from it."""
    a, b = _rglru_gates(p, x, mode)
    h = linear_scan(a, b) if state is None else a * state[:, None] + b
    return h.to(x.dtype), h[:, -1]


def _mlp(p: dict, x: Tensor, cfg: ArchConfig, mode: QuantMode) -> Tensor:
    return L.mlp(p["mlp"], L.rmsnorm(p["ln_mlp"], x), gated=cfg.gated_mlp,
                 activation=cfg.activation, mode=mode)


def rec_block(p: dict, x: Tensor, cfg: ArchConfig, *, mode: QuantMode = FP,
              state: Optional[Tuple[Tensor, Tensor]] = None
              ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """One recurrent block over x (B, S, D).  ``state=None`` runs the
    full sequence; ``state=(h, conv)`` (h (B, W) f32, conv (B, width - 1,
    W)) one decode step.  Returns (x out, the new (h, conv) or None)."""
    h = L.rmsnorm(p["ln"], x)
    a = linear(p["w_in_a"], h, mode=mode)
    b = linear(p["w_in_b"], h, activation="gelu", mode=mode)
    a, new_conv = S._causal_conv(a, p["conv_w"], p["conv_b"],
                                 None if state is None else state[1])
    a, new_h = rglru(p["lru"], a, mode=mode,
                     state=None if state is None else state[0])
    x = x + linear(p["w_out"], (a * b).to(x.dtype), mode=mode)
    x = x + _mlp(p, x, cfg, mode)
    return x, None if state is None else (new_h, new_conv)


def attn_block(p: dict, x: Tensor, cfg: ArchConfig, *, mode: QuantMode = FP,
               rope: Tuple[Tensor, Tensor], **cache_args) -> Tensor:
    """One local-attention block: the full-sequence form through the flash
    kernel with the window, or (``cache_args``: ``kv_cache``,
    ``cache_index``, ``valid_len``, ``block_tables``) one decode step
    against the ring (``layers.attention``'s bf16 path)."""
    h = L.rmsnorm(p["ln"], x)
    x = x + L.attention(p["attn"], h, _attn_cfg(cfg), mode=mode, rope=rope,
                        **cache_args)
    return x + _mlp(p, x, cfg, mode)


# ---------------------------------------------------------------------------
# the full model
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            mode: QuantMode = FP, remat: bool = True) -> Tensor:
    """Full-sequence forward (prefill, the service curve): tokens (B, S) ->
    logits (B, S, V) f32.  Every W8A16 matmul takes the tensor-core
    kernel (``w8a16_path="mma"``): under W8A16 every projection, and
    under W8A8 too the RG-LRU gates (W8A16 whatever the mode) and the
    head; the W8A8 kernels do not read the path.  ``remat`` is the
    reference's training switch; it has no effect here."""
    if mode.enabled:
        mode = dataclasses.replace(mode, w8a16_path="mma")
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = L.embed(params["embed"], tokens)
    for gp in params["groups"]:
        x, _ = rec_block(gp["rec0"], x, cfg, mode=mode)
        x, _ = rec_block(gp["rec1"], x, cfg, mode=mode)
        x = attn_block(gp["attn"], x, cfg, mode=mode, rope=rope)
    for lp in params.get("leftover", ()):
        x, _ = rec_block(lp, x, cfg, mode=mode)
    x = L.rmsnorm(params["ln_f"], x)
    return L.unembed(params["embed"], x, path=mode.w8a16_path)


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device=None) -> dict:
    """Fixed-size decode state, zeros: the RG-LRU states and conv tails,
    and the local-window ring k/v of ``min(local_window, s_max)`` slots,
    bf16 whatever ``cfg.kv_quant`` says (as the reference's)."""
    device = resolve_device(device)
    n_groups, leftover = _layout(cfg)
    w = cfg.rnn_width or cfg.d_model
    win = min(cfg.local_window, s_max)
    f32 = dict(dtype=torch.float32, device=device)
    bf16 = dict(dtype=torch.bfloat16, device=device)
    ring = (n_groups, batch, win, cfg.n_kv_heads, cfg.head_dim)
    cache = {"rnn_h": torch.zeros((n_groups, 2, batch, w), **f32),
             "conv": torch.zeros((n_groups, 2, batch, cfg.conv_width - 1, w),
                                 **bf16),
             "k": torch.zeros(ring, **bf16), "v": torch.zeros(ring, **bf16)}
    if leftover:
        cache["lo_rnn_h"] = torch.zeros((leftover, batch, w), **f32)
        cache["lo_conv"] = torch.zeros(
            (leftover, batch, cfg.conv_width - 1, w), **bf16)
    return cache


def cache_batch_axes(cache: dict) -> dict:
    """Batch (slot) axis of each cache leaf: the grouped state stacks
    (group, block) ahead of it."""
    axes = {"rnn_h": 2, "conv": 2, "k": 1, "v": 1}
    if "lo_rnn_h" in cache:
        axes["lo_rnn_h"] = 1
        axes["lo_conv"] = 1
    return axes


def mask_inactive_slots(old: dict, new: dict, active: Tensor) -> dict:
    """The slot contract's freeze, out of place (the reference's hook):
    ``ssm.mask_inactive_slots`` on this family's slot axes.  The ring is
    positional and keeps ``new``'s: its reads are masked at each row's
    frontier."""
    return S.mask_inactive_slots(old, new, active, cache_batch_axes(new),
                                 skip=("k", "v"))


def decode_step(params: dict, tokens: Tensor, cache: dict, cache_index,
                cfg: ArchConfig, *, mode: QuantMode = FP,
                logits: bool = True, causal: bool = False
                ) -> Tuple[Optional[Tensor], dict]:
    """One-token decode: tokens (B, 1) -> logits (B, 1, V) f32, the cache
    written in place (and returned, for the reference's signature).
    ``logits=False`` skips the final norm and the head.

    ``cache_index`` is an int (a lockstep batch) or a (B,) tensor (the slot
    engine): each row's RoPE position, its ring slot ``p % win`` and its
    frontier ``min(p + 1, win)``; a row at 0 has its recurrent state and
    conv tails zeroed before the update (the scrub).  The cache view may
    carry ``slots`` (B,), the cache rows that the batch's rows are (the
    chunk step's view of one slot: its state is read and written there,
    and its ring row read through a one-entry table), or ``active`` (B,)
    bool, the tick's row mask: an inactive row keeps its state bitwise,
    the scrub included (the freeze).

    The recurrence takes one token a row per call, so a chunk of a row's
    tokens is that many calls (``causal`` is accepted for the common
    signature and needs s = 1).  Every W8A16 matmul takes the GEMV, as
    ``transformer.decode_step``'s; the ring attention is
    ``layers.bf16_cache_attention`` (``tree_sum``), so a row's bits do not
    depend on the batch."""
    if mode.w8a16_path != "gemv":
        mode = dataclasses.replace(mode, w8a16_path="gemv")
    b, s = tokens.shape
    if s != 1:
        raise ValueError(f"the RG-LRU decode step takes one token a row, "
                         f"got {s}: feed a chunk one token per call")
    device = tokens.device
    win = cache["k"].shape[2]
    positions = T.decode_positions(cache_index, b, 1, device)     # (B, 1)
    fresh = positions[:, 0] == 0
    valid_len = torch.clamp_max(positions[:, 0] + 1, win)
    slots, active = cache.get("slots"), cache.get("active")
    if slots is not None:
        slots = slots.long()
        rows = slots
        tables = slots.int().reshape(-1, 1)
    else:
        rows = torch.arange(b, device=device)
        tables = None
    write_idx = (rows[:, None], (positions % win).long())
    rope = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    def rec(p, x, h_all, conv_all):
        return S.update_state((h_all, conv_all), fresh, slots, active,
                              lambda st: rec_block(p, x, cfg, mode=mode,
                                                   state=st))

    x = L.embed(params["embed"], tokens)
    for g, gp in enumerate(params["groups"]):
        x = rec(gp["rec0"], x, cache["rnn_h"][g, 0], cache["conv"][g, 0])
        x = rec(gp["rec1"], x, cache["rnn_h"][g, 1], cache["conv"][g, 1])
        x = attn_block(gp["attn"], x, cfg, mode=mode, rope=rope,
                       kv_cache=(cache["k"][g], cache["v"][g]),
                       cache_index=write_idx, valid_len=valid_len,
                       block_tables=tables)
    for i, lp in enumerate(params.get("leftover", ())):
        x = rec(lp, x, cache["lo_rnn_h"][i], cache["lo_conv"][i])
    if not logits:
        return None, cache
    x = L.rmsnorm(params["ln_f"], x)
    return L.unembed(params["embed"], x), cache
