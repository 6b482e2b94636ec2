"""Fused attention over a whole sequence: the CUDA kernel's wrapper and its
plain version.

``flash_attention_bhsd`` launches ``csrc/flash_attention_bhsd.cu``, the
Hopper port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``.  It takes CUDA
tensors only, checks them, allocates the output, launches on the current
stream and raises if the launch was refused.  Each launch adds one to
``flash_attention_bhsd.launches`` (``kernels/counts.py``).

``flash_attention_ref`` is the plain PyTorch version (the port of
``repro/kernels/ref.py::flash_attention_ref``, with the kernel's ``kv_len``
and ``sm_scale``): dense f32 scores, the masks, a softmax, masked
probabilities set to 0 (a row with no valid key gives 0), and the f32
context cast to ``out_dtype``.  Each call adds one to
``flash_attention_ref.calls``.

Shapes: q (BH, Sq, hd); k, v (BH, Skv, hd), heads already expanded to H.
The key at position kpos is seen by the query at qpos when kpos < kv_len,
and (causal) kpos <= qpos, and (window) kpos > qpos - window.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, counts

NEG_INF = -1e30
MAX_HD = 256        # the kernel's largest head_dim
_OUT_TYPES = (torch.float32, torch.bfloat16)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        kv_len: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense masked softmax attention, f32 inside."""
    flash_attention_ref.calls += 1
    _, sq, hd = q.shape
    skv = k.shape[1]
    kv_len = skv if kv_len is None else kv_len
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    return torch.matmul(p, v.float()).to(out_dtype)


flash_attention_ref.calls = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and bound once per process."""
    lib = _build.load("flash_attention_bhsd")
    fn = lib.flash_attention_bhsd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         kv_len: Optional[int] = None,
                         sm_scale: Optional[float] = None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """Masked softmax attention on the card.

    q: (BH, Sq, hd), k, v: (BH, Skv, hd), all bf16, contiguous, on one
    CUDA device, 16-byte aligned; hd a multiple of 8 up to 256 (above
    128 the kernel's HD = 256 instance, 128 threads a block); any Sq,
    Skv and 0 <= kv_len <= Skv; ``window`` None or >= 1; out (BH, Sq, hd)
    ``out_dtype`` (bf16/f32)."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bhsd launches a CUDA kernel: q "
                         "must be a CUDA tensor (CPU tensors go to "
                         "flash_attention_ref)")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if hd % 8 or not 0 < hd <= MAX_HD:
        raise ValueError(f"hd must be a multiple of 8 up to {MAX_HD}, "
                         f"got {hd}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len={kv_len} outside [0, Skv={skv}]")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"out {out_dtype} must be f32 or bf16")
    for t in (q, k, v):
        if (t.dtype != torch.bfloat16 or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("flash_attention_bhsd needs contiguous, "
                             "16-byte aligned bf16 tensors on q's device")
    sm_scale = hd ** -0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty((bh, sq, hd), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(out_dtype == torch.bfloat16), bh, sq, skv, hd, kv_len,
             int(causal), 0 if window is None else int(window), sm_scale,
             stream)
    if err:
        raise RuntimeError(f"flash_attention_bhsd launch failed: CUDA error "
                           f"{err}")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
counts.register(flash_attention_bhsd)
