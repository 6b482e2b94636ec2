"""Mixture-of-Experts LM (qwen2-moe-a2.7b, mixtral-8x22b): the serving
subset of ``repro/models/moe.py``.

A decoder layer is the dense one (``models/transformer.py``) with an MoE
FFN in the place of the MLP: an f32 router -> the top-k experts of each
token -> the tokens scattered into an (E, C, D) dispatch buffer per batch
row (C = capacity) -> the experts' gated MLP, one launch per matrix over
every expert (``kernels/ops.py::qmatmul_experts``) -> the weighted
combine, plus the always-on shared MLP where the config has one
(qwen2-moe's 4; mixtral has none, and an untied head).  The KV caches,
the attention and the layer loop are the dense family's, mixtral's
sliding-window ring included: this module holds the FFN and the layer's
init and hands them to ``transformer``'s functions.

Where the port differs from the reference, and why:
- the batch rows' dispatch buffers are one (E, B·C, D) stack, expert
  major, so each expert's B·C rows are one (M, K) operand of the stacked
  GEMV.  A dropped assignment is written to a trash row past the stack
  (the reference adds a zero at place 0); the combine gathers place 0 for
  it with weight 0, as the reference does;
- top-k is a stable descending sort: of two equal probabilities the
  lower expert index comes first, as ``lax.top_k`` breaks ties
  (``torch.topk`` promises no order among ties);
- the sums over the k choices (the renormalisation and the combine) add
  the k terms first to last in f32, so a row's bits do not depend on
  the rows beside it (a ``sum`` picks its reduction layout from the
  shape on the card); the combine rounds once, to the activations' dtype;
- the experts' products run on the W8A16 kernels over the stack under
  every mode, as the reference's ``emm`` ignores ``mode`` (under W8A8 only
  the attention's and the shared MLP's activations are quantized): the
  GEMV at every decode step, the tensor-core kernel at the full-sequence
  forward (``mode.w8a16_path``, which ``transformer`` sets per caller;
  under W8A8 the GEMV).  A ``live`` mask of the stack's rows that the
  routing filled goes with them, so the kernels skip the experts no token
  was routed to.  The router is the W8A16 GEMV with f32 activations
  (``mode=FP``, a QTensor weight).  The gate's activation is the kernels'
  fused drain, on the f32 sums, where the reference rounds the product to
  the activations' dtype first;
- with ``per_token`` (the chunk step's causal pass) each token of a row is
  routed alone, with the capacity of one token, as the reference's chunk
  step scans its one-token decode step.

Not ported yet: training's ``aux_load_balance_loss`` (ROADMAP queue 1,
item 15).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode, linear
from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.qmatmul import activate
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack(gen, shape, std: float, dtype, device) -> Tensor:
    """A stack of expert weights, truncated normal in [-2, 2] std units."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return t.mul_(std).to(dtype)


def init_moe_ffn(gen, cfg: ArchConfig, dtype=torch.float32,
                 device=None) -> dict:
    """The reference's ``init_moe_ffn``: an f32 (D, E) router, the gated
    experts' stacks (E, D, F), (E, D, F) and (E, F, D), and the shared
    MLP of width ``n_shared_experts * d_ff``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": TF._linear(gen, d, e, bias=False, dtype=torch.float32,
                              device=device),
         "experts": {"w_gate": _stack(gen, (e, d, f), d ** -0.5, dtype,
                                      device),
                     "w_up": _stack(gen, (e, d, f), d ** -0.5, dtype, device),
                     "w_down": _stack(gen, (e, f, d), f ** -0.5, dtype,
                                      device)}}
    if cfg.n_shared_experts:
        p["shared"] = TF.init_mlp(gen, d, f * cfg.n_shared_experts,
                                  gated=cfg.gated_mlp, dtype=dtype,
                                  device=device)
    return p


def init_layer(gen, cfg: ArchConfig, dtype, device) -> dict:
    attn = TF.init_attention(gen, cfg, dtype, device)
    return {"ln_attn": TF._norm(cfg, dtype, device), "attn": attn,
            "ln_mlp": TF._norm(cfg, dtype, device),
            "moe": init_moe_ffn(gen, cfg, dtype, device)}


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None) -> dict:
    """``transformer.init`` with MoE layers."""
    return TF.init(gen, cfg, dtype, device, layer=init_layer)


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32,
                   device=None) -> dict:
    """``transformer.init_quantized`` with MoE layers: one f32 layer (2.28
    GB at qwen2-moe-a2.7b's width, 9.7 GB at mixtral-8x22b's) at a time, each leaf quantized under
    its path in the whole tree (``layers.{i}.moe.experts.w_gate``,
    ``layers.{i}.moe.router.w``)."""
    return TF.init_quantized(gen, cfg, min_size=min_size, dtype=dtype,
                             device=device, layer=init_layer)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

def _sum_in_order(x: Tensor) -> Tensor:
    """Sum over the last dim in f32, first term to last."""
    total = x[..., 0].float()
    for j in range(1, x.shape[-1]):
        total = total + x[..., j].float()
    return total


def route(router: dict, x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Each token's k experts: f32 logits (the W8A16 GEMV on f32
    activations when the router is a QTensor), softmax, the k largest
    probabilities (ties to the lower index) renormalised by their sum.
    x (..., D) -> (top_p f32, top_e int64), each (..., k)."""
    logits = linear(router, x.float(), mode=FP, compute_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    return top_p / _sum_in_order(top_p)[..., None], top_e


def dispatch(top_e: Tensor, cap: int, e: int):
    """Each (token, choice)'s place in the (E, B·cap) stack of dispatch
    rows: the reference's cumsum over a row's flattened one-hots (so the
    same assignments are dropped).  top_e (B, S, k) -> (place (B, S·k)
    long, keep (B, S·k) bool); a dropped assignment's place is its
    expert's row 0 of the batch row, as the reference gathers it."""
    b, s, k = top_e.shape
    flat_e = top_e.reshape(b, s * k)
    onehot = flat_e[..., None] == torch.arange(e, device=top_e.device)
    pos = onehot.long().cumsum(dim=1) - 1
    my_pos = pos.gather(2, flat_e[..., None])[..., 0]
    keep = my_pos < cap
    row0 = torch.arange(b, device=top_e.device)[:, None] * cap
    place = flat_e * (b * cap) + row0 + torch.where(keep, my_pos, 0)
    return place, keep


def live_rows(place: Tensor, keep: Tensor, e: int, rows: int) -> Tensor:
    """The (E, rows) uint8 mask of the dispatch stack's rows that a kept
    assignment fills (:func:`dispatch`'s ``place`` where ``keep``), written
    on the device as the stack itself is (dropped ones on a trash row), so
    a captured step records it with static shapes."""
    live = torch.zeros(e * rows + 1, dtype=torch.uint8, device=place.device)
    live.index_fill_(0, torch.where(keep, place, e * rows).reshape(-1), 1)
    return live[:e * rows].view(e, rows)


def _experts(w, t: Tensor, activation: str = "none", *,
             live: Optional[Tensor] = None, path: str = "gemv") -> Tensor:
    """(E, M, K) x (E, K, N) -> (E, M, N) in t's dtype; a QTensor stack
    through the kernel ``path`` names, its dead rows (``live`` 0)
    ``act(0)``.  The plain bf16 product reads ``t`` as it is (its dead rows
    are zero)."""
    if isinstance(w, QTensor):
        return kops.qmatmul_experts(t, w, live=live, path=path,
                                    activation=activation, out_dtype=t.dtype)
    y = torch.matmul(t.to(torch.bfloat16).float(),
                     w.to(torch.bfloat16).float())
    return activate(y, activation).to(t.dtype)


def moe_ffn(p: dict, x: Tensor, cfg: ArchConfig, *, mode: QuantMode = FP,
            per_token: bool = False) -> Tensor:
    """x (B, S, D) -> (B, S, D).  Each batch row routes its own S tokens
    with capacity ``ceil(S·k / E · capacity_factor)`` (the reference's
    vmapped ``route_row``); with ``per_token`` each token is a row of its
    own (S = 1: capacity ``ceil(k / E · capacity_factor)``, nothing
    dropped)."""
    b, s, d = x.shape
    if per_token and s > 1:
        return moe_ffn(p, x.reshape(b * s, 1, d), cfg,
                       mode=mode).reshape(b, s, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(s * k / e * cfg.capacity_factor))
    top_p, top_e = route(p["router"], x, k)
    place, keep = dispatch(top_e, cap, e)
    rows = b * cap
    # the stack and its trash row: kept assignments have places of their
    # own, dropped ones all land on the trash row
    buf = x.new_zeros((e * rows + 1, d))
    buf.index_copy_(0, torch.where(keep, place, e * rows).reshape(-1),
                    x.repeat_interleave(k, dim=1).reshape(-1, d))
    disp = buf[:e * rows].view(e, rows, d)
    kw = dict(live=live_rows(place, keep, e, rows), path=mode.w8a16_path)
    ex = p["experts"]
    h = (_experts(ex["w_gate"], disp, cfg.activation, **kw)
         * _experts(ex["w_up"], disp, **kw))
    out = _experts(ex["w_down"], h, **kw).reshape(e * rows, d)
    gathered = out.index_select(0, place.reshape(-1)).reshape(b, s, k, d)
    weight = (top_p * keep.reshape(b, s, k)).to(x.dtype)
    out = _sum_in_order((gathered * weight[..., None]).transpose(-1, -2))
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + L.mlp(p["shared"], x, gated=cfg.gated_mlp,
                          activation=cfg.activation, mode=mode)
    return out


def layer_ffn(lp: dict, h: Tensor, cfg: ArchConfig, *, mode: QuantMode,
              per_token: bool = False) -> Tensor:
    """The MoE layer's FFN, ``lp["moe"]`` (``transformer``'s ``ffn``)."""
    return moe_ffn(lp["moe"], h, cfg, mode=mode, per_token=per_token)


# ---------------------------------------------------------------------------
# the model: the dense loops with the MoE FFN, the dense caches
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            mode: QuantMode = FP, remat: bool = True) -> Tensor:
    """``transformer.forward`` with MoE layers: each batch row routes its
    S tokens with the capacity of S (tokens past an expert's capacity are
    dropped, as in the reference)."""
    return TF.forward(params, tokens, cfg, mode=mode, remat=remat,
                      ffn=layer_ffn)


def decode_step(params: dict, tokens: Tensor, cache: dict, cache_index,
                cfg: ArchConfig, *, mode: QuantMode = FP,
                logits: bool = True, causal: bool = False
                ) -> Tuple[Optional[Tensor], dict]:
    """``transformer.decode_step`` with MoE layers: a row's s tokens route
    together (capacity of s), or with ``causal=True`` one at a time."""
    return TF.decode_step(params, tokens, cache, cache_index, cfg, mode=mode,
                          logits=logits, causal=causal, ffn=layer_ffn)


init_cache = TF.init_cache
init_paged_cache = TF.init_paged_cache
paged_block_axes = TF.paged_block_axes
# the MoE tree has the dense one's {embed, layers, ln_f[, unembed]} shape,
# so the self-draft's view of the first layers applies as it is
draft_params = TF.draft_params
