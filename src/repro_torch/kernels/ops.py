"""Public entry points of the port's kernels — the only module model code
imports from ``kernels/``.

- accept ND activations (leading dims flattened to M) and ``QTensor``
  weights,
- dispatch on where the tensors lie: a CUDA tensor goes to the Hopper
  kernel (which launches or raises), a CPU tensor to the kernel's plain
  version.  There is no other path between them and no fallback.

Unlike the TPU wrappers in ``repro/kernels/ops.py`` there is no padding of
M/N/K to block multiples, nor of G and hd to sublane and lane tiles: the
CUDA kernels mask their ragged edges themselves.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QTensor, quantize
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import qmatmul as _k


def qmatmul(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
            x_q: Optional[QTensor] = None, activation: str = "none",
            out_dtype=torch.bfloat16, path: str = "gemv") -> torch.Tensor:
    """act((x @ dequant(w)) + bias) with int8 weights.

    ``x`` (..., K) bf16/f32; ``w`` a QTensor (K, N) with one scale per
    column.  If ``x_q`` is given (``x`` quantized to int8 with one scale
    for the whole tensor), the W8A8 integer path runs; otherwise
    weight-only W8A16, on the card through the kernel ``path`` names (one
    of ``qmatmul.W8A16_PATHS``; the plain version runs on the CPU
    whatever it is)."""
    if path not in _k.W8A16_PATHS:
        raise ValueError(f"unknown path {path!r}")
    lead = x.shape[:-1]
    n = w.shape[-1]
    if x_q is not None:
        xq2 = x_q.values.reshape(-1, x.shape[-1])
        xs = x_q.scale.reshape(())
        if xq2.is_cuda:
            out = _k.qmatmul_w8a8(xq2.contiguous(), w.values, xs, w.scale,
                                  bias, activation=activation,
                                  out_dtype=out_dtype)
        else:
            out = _k.qmatmul_w8a8_ref(xq2, w.values, xs, w.scale, bias,
                                      activation=activation,
                                      out_dtype=out_dtype)
        return out.reshape(*lead, n)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        out = _k.qmatmul_w8a16_on_path(path, x2.contiguous(), w.values,
                                       w.scale, bias, activation=activation,
                                       out_dtype=out_dtype)
    else:
        out = _k.qmatmul_w8a16_ref(x2, w.values, w.scale, bias,
                                   activation=activation,
                                   out_dtype=out_dtype)
    return out.reshape(*lead, n)


def qmatmul_experts(x: torch.Tensor, w: QTensor, *,
                    live: Optional[torch.Tensor] = None, path: str = "gemv",
                    activation: str = "none",
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """act(x[e] @ dequant(w[e])) for a stack of experts: ``x`` (E, M, K)
    bf16/f32, ``w`` a QTensor (E, K, N) with one scale per (expert,
    column), ``live`` (E, M) uint8 or None (a dead row's output is
    ``act(0)``), out (E, M, N).  On the card one launch over the stack
    through the kernel ``path`` names (``qmatmul.qmatmul_w8a16_experts``),
    on the CPU its plain version whatever the path is."""
    if path not in _k.W8A16_PATHS:
        raise ValueError(f"unknown path {path!r}")
    if x.is_cuda:
        return _k.qmatmul_w8a16_experts(x.contiguous(), w.values, w.scale,
                                        live=live, path=path,
                                        activation=activation,
                                        out_dtype=out_dtype)
    return _k.qmatmul_w8a16_experts_ref(x, w.values, w.scale, live=live,
                                        activation=activation,
                                        out_dtype=out_dtype)


def qmatmul_dynamic(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
                    *, activation: str = "none",
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8 with the activations quantized on the fly, one scale for the
    whole tensor (the TPU's quantize-on-entry to the Unified Buffer)."""
    x_q = quantize(x.float(), bits=8, axis=None)
    return qmatmul(x, w, bias, x_q=x_q, activation=activation,
                   out_dtype=out_dtype)


def decode_attention(q, k, v, k_scale, v_scale, valid_len, *,
                     block_tables=None, k_new=None, v_new=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Fused one-token attention against an int8 KV cache.

    q: (B, KV, G, hd) bf16/f32; k, v: (B, S, KV, hd) int8; k_scale,
    v_scale: (B, S, KV) or (B, S, KV, 1) f32; valid_len: int, () or (B,)
    — slots with index < valid_len[b] take part.  ``k_new``/``v_new``
    (B, 1, KV, hd) or (B, KV, hd): the append column.

    ``block_tables`` (B, MB) int32 switches to the PAGED cache: k, v are
    then physical blocks (NB, bs, KV, hd) (scales (NB, bs, KV[, 1])),
    logical slot s of row b lies in block ``block_tables[b, s // bs]`` at
    offset ``s % bs``, and valid_len counts logical slots."""
    b = q.shape[0]
    vl = valid_len
    if not (isinstance(vl, torch.Tensor) and vl.dtype == torch.int32
            and vl.shape == (b,)):
        vl = torch.as_tensor(vl, dtype=torch.int32, device=q.device)
        vl = vl.reshape(-1).expand(b).contiguous()
    if block_tables is not None:
        if q.is_cuda:
            out = _da.decode_attention_int8_paged(
                q, k, v, k_scale, v_scale, vl, block_tables,
                k_new=k_new, v_new=v_new)
        else:
            out = _da.decode_attention_int8_paged_ref(
                q, k, v, k_scale, v_scale, vl, block_tables,
                k_new=k_new, v_new=v_new)
    elif q.is_cuda:
        out = _da.decode_attention_int8(q, k, v, k_scale, v_scale, vl,
                                        k_new=k_new, v_new=v_new)
    else:
        out = _da.decode_attention_int8_ref(q, k, v, k_scale, v_scale, vl,
                                            k_new=k_new, v_new=v_new)
    return out.to(out_dtype)


class _FlashAttention(torch.autograd.Function):
    """Fused attention (BH, S, hd) with its gradient: the forward is the
    kernel on a CUDA tensor (its plain version on a CPU one); the backward
    is ``flash_attention.flash_attention_bwd``, which recomputes the
    probabilities from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len, sm_scale, out_dtype):
        fn = (_fa.flash_attention_bhsd if q.is_cuda
              else _fa.flash_attention_ref)
        ctx.save_for_backward(q, k, v)
        ctx.masks = dict(causal=causal, window=window, kv_len=kv_len,
                         sm_scale=sm_scale)
        return fn(q, k, v, causal=causal, window=window, kv_len=kv_len,
                  sm_scale=sm_scale, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, dout, **ctx.masks)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    out_dtype=None) -> torch.Tensor:
    """Fused attention over a whole sequence.  q: (B, Sq, H, hd); k, v:
    (B, Skv, H, hd) (KV already expanded to H heads); out (B, Sq, H, hd)
    in ``out_dtype`` (default q's).  Every key is valid (kv_len = Skv) and
    the scores are scaled by hd**-0.5.  Differentiable: autograd reaches
    q, k and v through ``flash_attention.flash_attention_bwd``."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    out_dtype = out_dtype or q.dtype
    # at b == 1 the reshape is a strided view, not a copy
    qr = q.transpose(1, 2).reshape(b * h, sq, hd).contiguous()
    kr = k.transpose(1, 2).reshape(b * h, skv, hd).contiguous()
    vr = v.transpose(1, 2).reshape(b * h, skv, hd).contiguous()
    out = _FlashAttention.apply(qr, kr, vr, causal, window, skv,
                                hd ** -0.5, out_dtype)
    return out.reshape(b, h, sq, hd).transpose(1, 2)
