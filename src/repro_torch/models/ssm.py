"""Mamba-2 (SSD, state-space duality), an attention-free LM
[arXiv:2405.21060]: the port of ``repro/models/ssm.py``.

The SSD layer computes y_t = C_t^T h_t,  h_t = a_t h_{t-1} + dt_t B_t x_t^T
with a scalar decay per head a_t = exp(dt_t * A).  The full-sequence
``forward`` (prefill, the service curve) runs the chunked algorithm: the
sequence is split into chunks of Q tokens, a masked (C_q B_k^T)
"attention" matmul inside each chunk and a recurrence over per-chunk
states (B, H, hd, N) between them.  ``decode_step`` is the O(1) state
update, one token a row per call.  The state h accumulates in f32; the
in and out projections and the tied head run through ``linear`` and
``unembed`` like every other matmul.  The reference has no kernel for the
scan or the state update, so both are plain PyTorch here.

Serving state (``init_cache``): ``h`` (L, B, H, hd, N) f32 and the conv
tail ``conv`` (L, B, conv_width - 1, d_inner + 2N) bf16, one row per slot
and no positional axis, so the slot contract's rule 3 holds here
(``docs/architecture.md``): a row decoding position 0 zeroes its carried
state first (the reset-at-zero scrub, which makes a reused slot's last
tenant invisible), and a row the tick does not advance keeps its state
bitwise (the freeze).  The reference's decode step returns a new cache
and its slot tick restores the inactive rows afterwards
(``mask_inactive_slots``); here the state is written in place, so the
step takes the tick's row mask as the cache view's ``active`` and writes
``where(active, new, old)`` itself, layer by layer.

Row invariance: the engine must equal its batch-1 reference bit for bit,
so every op of ``decode_step`` computes a row the same whatever the batch
beside it.  ``y = C . h`` over N is a product and a fixed-order sum
(``layers.tree_sum``), not a batched GEMV whose algorithm follows the
batch on the card; the conv keeps the reference's order (the width's
products summed first to last, then the bias, then ``silu``); the rest is
elementwise, the row-wise ``rmsnorm`` and the W8A16 GEMV.

Layout differences from the reference, as in ``models/transformer.py``:
``params["layers"]`` is a list of per-layer dicts and the cache is
written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode, linear
from repro_torch.core.quant import quantize_tree
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_ssd_layer(gen, cfg: ArchConfig, dtype, device) -> dict:
    """One Mamba-2 block: the fused in_proj ``[x (din), z (din), B (N),
    C (N), dt (H)]``, the depthwise conv (width, din + 2N), the per-head
    ``a_log``, ``dt_bias`` and ``D``, the out_proj; the reference's
    distributions, drawn in its order."""
    d, din, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    kw = dict(dtype=dtype, device=device)
    in_proj = T._linear(gen, d, 2 * din + 2 * n + nh, bias=False, **kw)
    conv_w = torch.empty((cfg.conv_width, din + 2 * n), dtype=torch.float32,
                         device=device)
    torch.nn.init.trunc_normal_(conv_w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    out_proj = T._linear(gen, din, d, bias=False, scale=din ** -0.5, **kw)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": T._norm(cfg, **kw),
        "in_proj": in_proj,
        "conv_w": (conv_w * 0.3).to(dtype),
        "conv_b": torch.zeros((din + 2 * n,), **kw),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.full((nh,), -2.0, **f32),
        "D": torch.ones((nh,), **f32),
        "out_proj": out_proj,
    }


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
         device=None) -> dict:
    """Random params from ``gen`` in the reference's order (the tied
    embedding table, the layers, the final norm); same distributions,
    other numbers (tests copy the reference's params over through
    ``models/bridge.py``)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    return {"embed": T._table(gen, cfg, **kw),
            "layers": [init_ssd_layer(gen, cfg, **kw)
                       for _ in range(cfg.n_layers)],
            "ln_f": T._norm(cfg, **kw)}


def init_quantized(gen: torch.Generator, cfg: ArchConfig, *,
                   min_size: int = 2048, dtype=torch.float32,
                   device=None) -> dict:
    """``quantize_tree(init(gen, cfg, dtype, device), min_size=min_size)``
    bit for bit, the table and each layer quantized as soon as they are
    drawn under the paths they have in the whole tree (``embed.table``,
    ``layers.{i}.in_proj.w``): peak memory is the int8 tree plus one f32
    layer or table.  The quantizer's path rule takes ``in_proj.w``,
    ``out_proj.w`` and the table; ``conv_w`` (it ends in ``_w``, not
    ``.w``), the norms and the per-head vectors stay f32, as the
    reference's ``quantize_tree`` leaves them."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)

    def quantized(tree, prefix):
        return quantize_tree(tree, min_size=min_size, prefix=prefix,
                             row_chunk=T.TABLE_ROW_CHUNK)

    params = {"embed": quantized(T._table(gen, cfg, **kw), "embed"),
              "layers": []}
    for i in range(cfg.n_layers):
        params["layers"].append(
            quantized(init_ssd_layer(gen, cfg, **kw), f"layers.{i}"))
    params["ln_f"] = T._norm(cfg, **kw)
    return params


# ---------------------------------------------------------------------------
# the SSD layer
# ---------------------------------------------------------------------------

def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)).  ``F.softplus`` computes log1p(exp(x)) and turns
    into the identity above its threshold, other roundings."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _segsum(log_a: Tensor) -> Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} log_a[..., k]
    for j <= i (lower triangle), -inf above the diagonal."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=log_a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, float("-inf"))


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d over x (B, S, C) with w (width, C): the
    width's products summed first to last in x's dtype, then the bias,
    then ``silu``.  ``state`` is the last width - 1 inputs (decode carries
    them; None pads with zeros).  Returns (out, new_state)."""
    width, s = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    w = w.to(x.dtype)
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return F.silu(out + b.to(x.dtype)), xp[:, s:]


def _ssd_chunked(xh: Tensor, dt: Tensor, a_log: Tensor, bm: Tensor,
                 cm: Tensor, chunk: int) -> Tensor:
    """The chunked SSD scan: xh (B, S, H, hd), dt (B, S, H), bm and cm
    (B, S, N) -> y (B, S, H, hd) in xh's dtype; the state in f32.  The
    sequence is padded with zeros to whole chunks of min(chunk, S)."""
    b, s, h, hd = xh.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = xh.shape[1] // q
    A = -torch.exp(a_log)                                   # (H,)
    state = torch.zeros((b, h, hd, n), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        t = slice(c * q, (c + 1) * q)
        xq, dtq = xh[:, t].float(), dt[:, t].float()       # (B,q,H,hd) (B,q,H)
        bq, cq = bm[:, t].float(), cm[:, t].float()        # (B,q,N)
        la = (dtq * A).transpose(1, 2)                      # (B,H,q) <= 0
        decay = torch.exp(_segsum(la))                      # (B,H,q,q)
        # intra-chunk: scores (B,H,q,q) = C_i . B_j * decay * dt_j
        scores = torch.einsum("bin,bjn->bij", cq, bq)
        scores = scores[:, None] * decay * dtq.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhij,bjhd->bihd", scores, xq)
        # inter-chunk: the carried state's contribution
        cum = torch.cumsum(la, dim=-1)                      # (B,H,q)
        y_inter = torch.einsum("bin,bhdn,bhi->bihd", cq, state,
                               torch.exp(cum))
        # h' = a_total h + sum_j decay_rest_j dt_j B_j x_j
        total = la.sum(dim=-1, keepdim=True)                # (B,H,1)
        contrib = torch.einsum("bjn,bjhd,bhj,bjh->bhdn", bq, xq,
                               torch.exp(total - cum), dtq)
        state = torch.exp(total)[..., None] * state + contrib
        ys.append((y_intra + y_inter).to(xh.dtype))
    return torch.cat(ys, dim=1)[:, :s]


def ssd_layer(p: dict, x: Tensor, cfg: ArchConfig, *, mode: QuantMode = FP,
              state: Optional[Tuple[Tensor, Tensor]] = None
              ) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """One Mamba-2 block over x (B, S, D).  ``state=None`` runs the chunked
    full-sequence form; ``state=(h, conv)`` (h (B, H, hd, N) f32, conv (B,
    width - 1, din + 2N)) one decode step of S = 1.  Returns (x + out,
    the new (h, conv) or None)."""
    b, s, _ = x.shape
    din, n, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    proj = linear(p["in_proj"], L.rmsnorm(p["norm"], x), mode=mode)
    xbc = torch.cat([proj[..., :din], proj[..., 2 * din:2 * din + 2 * n]],
                    dim=-1)
    z = proj[..., din:2 * din]
    dt = softplus(proj[..., 2 * din + 2 * n:].float() + p["dt_bias"])
    conv_out, new_conv = _causal_conv(
        xbc, p["conv_w"], p["conv_b"], None if state is None else state[1])
    xh = conv_out[..., :din].reshape(b, s, nh, hd)
    bm, cm = conv_out[..., din:din + n], conv_out[..., din + n:]
    if state is None:
        y = _ssd_chunked(xh, dt, p["a_log"], bm, cm, cfg.ssm_chunk).float()
        new_state = None
    else:
        # O(1) decode: h' = a h + dt B x ; y = C . h', summed over N in a
        # fixed order (a row's bits do not depend on the batch)
        dt0 = dt[:, 0]                                      # (B, H)
        a_step = torch.exp(dt0 * -torch.exp(p["a_log"]))
        dtx = xh[:, 0].float() * dt0[..., None]             # (B, H, hd)
        b0 = bm[:, 0].float()[:, None, None, :]             # (B, 1, 1, N)
        new_h = a_step[..., None, None] * state[0] + dtx[..., None] * b0
        c0 = cm[:, 0].float()[:, None, None, :]
        y = L.tree_sum(c0 * new_h)[:, None]                 # (B, 1, H, hd)
        new_state = (new_h, new_conv)
    y = y + p["D"][:, None] * xh.float()
    y = (y.reshape(b, s, din) * F.silu(z.float())).to(x.dtype)
    return x + linear(p["out_proj"], y, mode=mode), new_state


# ---------------------------------------------------------------------------
# the full model
# ---------------------------------------------------------------------------

def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            mode: QuantMode = FP, remat: bool = True) -> Tensor:
    """Full-sequence forward (prefill, the service curve): tokens (B, S) ->
    logits (B, S, V) f32 through the chunked SSD.  Under W8A16 every
    projection and the head take the tensor-core kernel
    (``w8a16_path="mma"``), as ``transformer.forward``'s.  ``remat`` is
    the reference's rematerialization for training, each layer under
    ``transformer.remat_call``."""
    if mode.enabled and not mode.w8a8:
        mode = dataclasses.replace(mode, w8a16_path="mma")

    def layer(x, lp):
        return ssd_layer(lp, x, cfg, mode=mode)[0]

    x = L.embed(params["embed"], tokens)
    for lp in params["layers"]:
        x = T.remat_call(remat, layer, x, lp)
    x = L.rmsnorm(params["ln_f"], x)
    return L.unembed(params["embed"], x, path=mode.w8a16_path)


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               device=None) -> dict:
    """The fixed-size decode state, zeros: ``h`` (L, B, H, hd, N) f32 and
    the conv tail ``conv`` (L, B, width - 1, din + 2N) bf16, whatever
    ``s_max`` (the state has no positional axis)."""
    device = resolve_device(device)
    nh, hd, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {"h": torch.zeros((cfg.n_layers, batch, nh, hd, n),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1,
                                 cfg.d_inner + 2 * n),
                                dtype=torch.bfloat16, device=device)}


def _rows(mask: Tensor, like: Tensor) -> Tensor:
    """A (B,) row mask shaped to broadcast over ``like`` (B, ...)."""
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def update_state(states: Tuple[Tensor, ...], fresh: Tensor,
                 slots: Optional[Tensor], active: Optional[Tensor], step):
    """The slot contract on one block's recurrent state, written in place
    (this family's and the hybrid's decode steps): ``states`` the block's
    cache tensors (rows first), read at the view's ``slots`` (else every
    row), zeroed on the rows that are ``fresh`` (the scrub), handed to
    ``step(state) -> (out, new_state)``, and the new state written back
    at ``slots``, or where the tick's row mask ``active`` is set (the
    freeze: an inactive row's element is its own old value), or whole.
    Returns ``out``."""
    old = states if slots is None else tuple(t[slots] for t in states)
    out, new = step(tuple(torch.where(_rows(fresh, t), 0.0, t) for t in old))
    for t, n in zip(states, new):
        if slots is not None:
            t.index_copy_(0, slots, n)
        elif active is not None:
            torch.where(_rows(active, n), n, t, out=t)
        else:
            t.copy_(n)
    return out


def mask_inactive_slots(old: dict, new: dict, active: Tensor,
                        axes: Optional[dict] = None, skip=()) -> dict:
    """The slot contract's freeze, out of place (the reference's hook):
    ``new`` with the inactive rows' state restored from ``old`` bitwise.
    ``axes`` gives each leaf's slot axis (default 1, behind the layer
    axis, as this family's h and conv); the leaves in ``skip`` (a
    positional cache, the hybrid's ring) keep ``new``'s.  A recurrent
    state has no ``valid_len`` frontier that could hide a clobbered row,
    so a row the tick does not advance must keep it.  ``decode_step``
    applies the same rule in place, layer by layer."""
    out = dict(new)
    for name, t in new.items():
        if name in skip:
            continue
        axis = 1 if axes is None else axes[name]
        rows = active.reshape((1,) * axis + (-1,) + (1,) * (t.ndim - axis - 1))
        out[name] = torch.where(rows, t, old[name])
    return out


def decode_step(params: dict, tokens: Tensor, cache: dict, cache_index,
                cfg: ArchConfig, *, mode: QuantMode = FP,
                logits: bool = True, causal: bool = False
                ) -> Tuple[Optional[Tensor], dict]:
    """One-token decode: tokens (B, 1) -> logits (B, 1, V) f32, the state
    written in place (and the cache returned, for the reference's
    signature).  ``logits=False`` skips the final norm and the head.

    ``cache_index`` is an int (a lockstep batch) or a (B,) tensor (the
    slot engine).  The state has no positions, so the index's one use is
    the reset-at-zero scrub: a row at position 0 has no history, and its
    carried ``h`` and conv tail are zeroed before the update.  The cache
    view may carry ``slots`` (B,): the cache rows that the batch's rows
    are (the chunk step's view of one slot; without it row b is slot b),
    or ``active`` (B,) bool: the tick's row mask, where a row that is not
    active keeps its state bitwise, the scrub included (the freeze).  No
    caller gives both: the chunk step runs the slot it names, the tick
    masks the rows of the whole pool.

    The SSD decode takes one token a row per call, so a chunk of a row's
    tokens is that many calls (``causal`` is accepted for the common
    signature and needs s = 1).  Every W8A16 matmul takes the GEMV, as
    ``transformer.decode_step``'s."""
    if mode.w8a16_path != "gemv":
        mode = dataclasses.replace(mode, w8a16_path="gemv")
    b, s = tokens.shape
    if s != 1:
        raise ValueError(f"the SSD decode step takes one token a row, got "
                         f"{s}: feed a chunk one token per call")
    if isinstance(cache_index, int):
        fresh = torch.full((b,), cache_index == 0, dtype=torch.bool,
                           device=tokens.device)
    else:
        fresh = (cache_index == 0).reshape(-1).expand(b)
    slots, active = cache.get("slots"), cache.get("active")
    if slots is not None:
        slots = slots.long()
    x = L.embed(params["embed"], tokens)
    for i, lp in enumerate(params["layers"]):
        x = update_state((cache["h"][i], cache["conv"][i]), fresh, slots,
                         active, lambda st: ssd_layer(lp, x, cfg, mode=mode,
                                                      state=st))
    if not logits:
        return None, cache
    x = L.rmsnorm(params["ln_f"], x)
    return L.unembed(params["embed"], x), cache
