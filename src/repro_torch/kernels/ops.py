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

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import qmatmul as _k


def qmatmul(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
            activation: str = "none",
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """act((x @ dequant(w)) + bias) with int8 weights (weight-only W8A16).

    ``x`` (..., K) bf16/f32; ``w`` a QTensor (K, N) with one scale per
    column.  The per-tensor-activation W8A8 form (``qmatmul_dynamic``) is
    not ported yet (ROADMAP queue 2, kernel 4)."""
    lead = x.shape[:-1]
    n = w.shape[-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        out = _k.qmatmul_w8a16(x2.contiguous(), w.values, w.scale,
                               bias, activation=activation,
                               out_dtype=out_dtype)
    else:
        out = _k.qmatmul_w8a16_ref(x2, w.values, w.scale, bias,
                                   activation=activation,
                                   out_dtype=out_dtype)
    return out.reshape(*lead, n)


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
