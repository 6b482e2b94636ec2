"""Fused one-token attention over an int8 KV cache: the CUDA kernel's
wrapper and its plain version.

``decode_attention_int8`` launches ``csrc/decode_attention_int8.cu``, the
Hopper port of the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_int8``.  It takes
CUDA tensors only, checks them, allocates the f32 output, launches on the
current stream and raises if the launch was refused.  Each launch adds one
to ``decode_attention_int8.launches``.

``decode_attention_int8_ref`` is the plain PyTorch version (the port of
``repro/kernels/ref.py::decode_attention_int8_ref``): it dequantizes the
cache densely and runs a masked softmax, one batch row at a time, so a
row's result does not depend on the batch.  Each call adds one to
``decode_attention_int8_ref.calls``.

Shapes: q (B, KV, G, hd); k, v (B, S, KV, hd) int8; k_scale, v_scale
(B, S, KV) or (B, S, KV, 1) f32; valid_len (B,) int32 — slots with index
< valid_len[b] take part; k_new, v_new (B, KV, hd), optional: the append
column, one extra always-valid softmax column.  Out (B, KV, G, hd) f32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_G = 16          # query heads per kv head the kernel holds in registers
MAX_HD = 128        # head_dim: one thread per column


def decode_attention_int8_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor,
                              valid_len: torch.Tensor, *,
                              k_new: Optional[torch.Tensor] = None,
                              v_new: Optional[torch.Tensor] = None,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Dense one-token attention against an int8 KV cache, f32 out."""
    decode_attention_int8_ref.calls += 1
    b, kvh, g, hd = q.shape
    s_slots = k.shape[1]
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    ks = k_scale.reshape(k.shape[:3]).float()
    vs = v_scale.reshape(v.shape[:3]).float()
    vl = valid_len.reshape(-1).expand(b)
    pos = torch.arange(s_slots, device=q.device)
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    for r in range(b):
        kf = (k[r].float() * ks[r][..., None]).transpose(0, 1)   # (KV, S, hd)
        vf = (v[r].float() * vs[r][..., None]).transpose(0, 1)
        qr = q[r].float()                                         # (KV, G, hd)
        scores = (qr[:, :, None, :] * kf[:, None, :, :]).sum(-1) * sm_scale
        valid = pos < vl[r]                                       # (S,)
        scores = torch.where(valid, scores, NEG_INF)              # (KV, G, S)
        if k_new is not None:
            kn = k_new.reshape(b, kvh, hd)[r].float()
            s_new = (qr * kn[:, None, :]).sum(-1) * sm_scale      # (KV, G)
            scores = torch.cat([scores, s_new[..., None]], dim=-1)
        probs = torch.softmax(scores, dim=-1)
        p_cache = torch.where(valid, probs[..., :s_slots], 0.0)
        o = (p_cache[..., None] * vf[:, None, :, :]).sum(-2)      # (KV, G, hd)
        if v_new is not None:
            vn = v_new.reshape(b, kvh, hd)[r].float()
            o = o + probs[..., s_slots:] * vn[:, None, :]
        out[r] = o
    return out


decode_attention_int8_ref.calls = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and bound once per process."""
    lib = _build.load("decode_attention_int8")
    fn = lib.decode_attention_int8
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          valid_len: torch.Tensor, *,
                          k_new: Optional[torch.Tensor] = None,
                          v_new: Optional[torch.Tensor] = None,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The fused kernel on the card; same contract as the plain version.
    Needs G <= 16, hd <= 128 with hd % 16 == 0, and contiguous tensors."""
    if not q.is_cuda:
        raise ValueError("decode_attention_int8 launches a CUDA kernel: q "
                         "must be a CUDA tensor (CPU tensors go to "
                         "decode_attention_int8_ref)")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KV, G, hd), got {tuple(q.shape)}")
    b, kvh, g, hd = q.shape
    s_slots = k.shape[1]
    if g > MAX_G or hd > MAX_HD or hd % 16:
        raise ValueError(f"kernel needs G <= {MAX_G} and hd <= {MAX_HD} "
                         f"with hd % 16 == 0, got G={g} hd={hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if (k.shape != (b, s_slots, kvh, hd) or v.shape != k.shape
            or k.dtype != torch.int8 or v.dtype != torch.int8):
        raise ValueError(f"k/v must be int8 (B, S, KV, hd) = "
                         f"{(b, s_slots, kvh, hd)}")
    for sc in (k_scale, v_scale):
        if sc.dtype != torch.float32 or sc.numel() != b * s_slots * kvh:
            raise ValueError("k_scale/v_scale must hold B*S*KV f32 values")
    if valid_len.dtype != torch.int32 or valid_len.numel() != b:
        raise ValueError("valid_len must be (B,) int32")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new must be passed together")
    if k_new is not None:
        k_new = k_new.reshape(b, kvh, hd).float().contiguous()
        v_new = v_new.reshape(b, kvh, hd).float().contiguous()
    tensors = [q, k, v, k_scale, v_scale, valid_len]
    tensors += [k_new, v_new] if k_new is not None else []
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention_int8 needs contiguous "
                             "tensors on q's device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must be 16-byte aligned")
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
             v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
             valid_len.data_ptr(),
             k_new.data_ptr() if k_new is not None else None,
             v_new.data_ptr() if v_new is not None else None,
             out.data_ptr(), b, s_slots, kvh, g, hd, float(sm_scale), stream)
    if err:
        raise RuntimeError(
            f"decode_attention_int8 launch failed: CUDA error {err}")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
