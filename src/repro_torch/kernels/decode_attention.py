"""Fused one-token attention over an int8 KV cache: the CUDA kernels'
wrappers and their plain versions, for the contiguous and the paged cache.

``decode_attention_int8`` launches ``csrc/decode_attention_int8.cu``, the
Hopper port of the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_int8``;
``decode_attention_int8_paged`` launches
``csrc/decode_attention_int8_paged.cu``, the port of
``::decode_attention_int8_paged``.  Both share one kernel body
(``csrc/decode_attention_int8.cuh``), which cuts each row's valid slots
into at most ``DECODE_NSPLIT`` chunks (:func:`decode_chunk_bounds`), one
block each, and combines the chunks in chunk order in the same launch,
through a workspace and counters kept per (device, stream)
(``kernels/scratch.py``).  A wrapper takes CUDA tensors only,
checks them, allocates the f32 output, launches on the current stream and
raises if the launch was refused.  Each launch adds one to its
``.launches`` (``kernels/counts.py``).

``decode_attention_int8_ref`` is the plain PyTorch version (the port of
``repro/kernels/ref.py::decode_attention_int8_ref``): it dequantizes the
cache densely and runs a masked softmax, one batch row at a time, so a
row's result does not depend on the batch.
``decode_attention_int8_paged_ref`` (the port of
``ref.py::decode_attention_paged_ref``) gathers each row's blocks through
its table into the contiguous view and does the same.  Each call of a
plain version adds one to its ``.calls``.

Shapes: q (B, KV, G, hd); k, v (B, S, KV, hd) int8; k_scale, v_scale
(B, S, KV) or (B, S, KV, 1) f32; valid_len (B,) int32 — slots with index
< valid_len[b] take part; k_new, v_new (B, KV, hd), optional: the append
column, one extra always-valid softmax column.  Out (B, KV, G, hd) f32.
Paged: k, v (NB, bs, KV, hd) physical blocks, scales (NB, bs, KV[, 1]),
block_tables (B, MB) int32 — logical slot s of row b lives in block
``block_tables[b, s // bs]`` at offset ``s % bs``; valid_len counts
logical slots.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, counts, scratch

NEG_INF = -1e30
MAX_G = 16          # query heads per kv head: one m16 tile of the products
MAX_HD = 128        # head_dim: the width of the kernel's tiles

# The kernels' split of a row's slots (csrc/decode_attention_int8.cuh:
# NSPLIT, CHUNK_ALIGN): at most DECODE_NSPLIT chunks, each a multiple of
# DECODE_CHUNK_ALIGN slots long.
DECODE_NSPLIT = 16
DECODE_CHUNK_ALIGN = 64


def decode_chunk_bounds(valid_len: int):
    """The chunks ``[(start, end), ...]`` that the kernels cut a row with
    ``valid_len`` valid slots into, in the order they are combined: chunks
    of ``roundup(ceil(valid_len / DECODE_NSPLIT), DECODE_CHUNK_ALIGN)``
    slots, the last one shorter, and one empty chunk for an empty row.  A
    function of ``valid_len`` alone -- never of the batch, the cache's
    capacity or its block size -- so a row's bits do not depend on them.
    The kernels compute the same bounds on the device; this function
    documents them and is what the tests check."""
    vl = max(int(valid_len), 0)
    if vl == 0:
        return [(0, 0)]
    per = -(-vl // DECODE_NSPLIT)
    length = -(-per // DECODE_CHUNK_ALIGN) * DECODE_CHUNK_ALIGN
    return [(s, min(vl, s + length)) for s in range(0, vl, length)]


def _attend_rows(q, k, v, ks, vs, vl, k_new, v_new, sm_scale):
    """The plain versions' arithmetic on a contiguous (B, S, KV, hd) view
    with (B, S, KV) scales, one row at a time."""
    b, kvh, g, hd = q.shape
    s_slots = k.shape[1]
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
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
    ks = k_scale.reshape(k.shape[:3]).float()
    vs = v_scale.reshape(v.shape[:3]).float()
    vl = valid_len.reshape(-1).expand(q.shape[0])
    return _attend_rows(q, k, v, ks, vs, vl, k_new, v_new, sm_scale)


decode_attention_int8_ref.calls = 0


def paged_gather(c: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Physical blocks (NB, bs, ...) gathered through per-row tables
    (B, MB) into the contiguous logical view (B, MB*bs, ...)."""
    g = c[block_tables.long()]                    # (B, MB, bs, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def decode_attention_int8_paged_ref(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, k_scale: torch.Tensor,
                                    v_scale: torch.Tensor,
                                    valid_len: torch.Tensor,
                                    block_tables: torch.Tensor, *,
                                    k_new: Optional[torch.Tensor] = None,
                                    v_new: Optional[torch.Tensor] = None,
                                    sm_scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """Dense one-token attention against a paged int8 KV cache, f32 out:
    the contiguous plain version on the gathered view, so the paged
    contract is the contiguous one composed with the table gather."""
    decode_attention_int8_paged_ref.calls += 1
    ks = k_scale.reshape(k.shape[:3]).float()
    vs = v_scale.reshape(v.shape[:3]).float()
    vl = valid_len.reshape(-1).expand(q.shape[0])
    return _attend_rows(q, paged_gather(k, block_tables),
                        paged_gather(v, block_tables),
                        paged_gather(ks, block_tables),
                        paged_gather(vs, block_tables), vl, k_new, v_new,
                        sm_scale)


decode_attention_int8_paged_ref.calls = 0


# each C entry point's arguments: (q, q_bf16, the tensors' pointers..., the
# ints..., sm_scale, stream)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "decode_attention_int8":
        [_PTR, _INT] + [_PTR] * 10 + [_INT] * 5 + [ctypes.c_float, _PTR],
    "decode_attention_int8_paged":
        [_PTR, _INT] + [_PTR] * 11 + [_INT] * 6 + [ctypes.c_float, _PTR],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """A kernel's C entry point, built and bound once per process."""
    fn = getattr(_build.load(name), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_q(name: str, q: torch.Tensor) -> None:
    if not q.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel: q must be a CUDA "
                         f"tensor (CPU tensors go to {name}_ref)")
    if q.ndim != 4:
        raise ValueError(f"q must be (B, KV, G, hd), got {tuple(q.shape)}")


def _check(name: str, q, k, v, k_scale, v_scale, valid_len, k_new, v_new,
           n_slots: int, extra=()):
    """The two wrappers' shared argument checks, after :func:`_check_q`;
    returns the append column as contiguous f32 (B, KV, hd) tensors, or
    (None, None).  k/v must hold ``n_slots`` (physical) slots of
    (KV, hd)."""
    b, kvh, g, hd = q.shape
    if g > MAX_G or hd > MAX_HD or hd % 16:
        raise ValueError(f"kernel needs G <= {MAX_G} and hd <= {MAX_HD} "
                         f"with hd % 16 == 0, got G={g} hd={hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    if (k.shape[-2:] != (kvh, hd) or k.numel() != n_slots * kvh * hd
            or v.shape != k.shape or k.dtype != torch.int8
            or v.dtype != torch.int8):
        raise ValueError(f"k/v must be int8 with {n_slots} slots of "
                         f"(KV, hd) = {(kvh, hd)}, got {tuple(k.shape)}")
    for sc in (k_scale, v_scale):
        if sc.dtype != torch.float32 or sc.numel() != n_slots * kvh:
            raise ValueError(f"k_scale/v_scale must hold {n_slots}*KV f32 "
                             f"values")
    if valid_len.dtype != torch.int32 or valid_len.numel() != b:
        raise ValueError("valid_len must be (B,) int32")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new must be passed together")
    if k_new is not None:
        k_new = k_new.reshape(b, kvh, hd).float().contiguous()
        v_new = v_new.reshape(b, kvh, hd).float().contiguous()
    tensors = [q, k, v, k_scale, v_scale, valid_len, *extra]
    tensors += [k_new, v_new] if k_new is not None else []
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on q's "
                             f"device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k/v must be 16-byte aligned")
    return k_new, v_new


def _scratch(q: torch.Tensor, stream: int):
    """The split's workspace (one (acc, m, l) partial per chunk of each
    (row, kv head), rounded up to whole float4s) and counters (one per
    (row, kv head))."""
    b, kvh, g, hd = q.shape
    partial = -(-g * (hd + 2) // 4) * 4
    return scratch.get(q.device, stream, b * kvh * DECODE_NSPLIT * partial,
                       b * kvh)


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          valid_len: torch.Tensor, *,
                          k_new: Optional[torch.Tensor] = None,
                          v_new: Optional[torch.Tensor] = None,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The fused kernel on the card; same contract as the plain version.
    Needs G <= 16, hd <= 128 with hd % 16 == 0, and contiguous tensors."""
    _check_q("decode_attention_int8", q)
    b, kvh, g, hd = q.shape
    if k.ndim != 4 or k.shape[0] != b:
        raise ValueError(f"k/v must be int8 (B, S, KV, hd) with B={b}, got "
                         f"{tuple(k.shape)}")
    s_slots = k.shape[1]
    k_new, v_new = _check("decode_attention_int8", q, k, v, k_scale,
                          v_scale, valid_len, k_new, v_new, b * s_slots)
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    fn = _lib("decode_attention_int8")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work, counters = _scratch(q, stream)
    err = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
             v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
             valid_len.data_ptr(),
             k_new.data_ptr() if k_new is not None else None,
             v_new.data_ptr() if v_new is not None else None,
             out.data_ptr(), work, counters, b, s_slots, kvh, g, hd,
             float(sm_scale), stream)
    if err:
        raise RuntimeError(
            f"decode_attention_int8 launch failed: CUDA error {err}")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
counts.register(decode_attention_int8)


def decode_attention_int8_paged(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor,
                                valid_len: torch.Tensor,
                                block_tables: torch.Tensor, *,
                                k_new: Optional[torch.Tensor] = None,
                                v_new: Optional[torch.Tensor] = None,
                                sm_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """The fused paged kernel on the card; same contract as the plain
    version.  Needs what the contiguous kernel needs, and a contiguous
    (B, MB) int32 table whose entries lie in [0, NB) (they are not checked
    on the host: that would wait for the card)."""
    _check_q("decode_attention_int8_paged", q)
    b, kvh, g, hd = q.shape
    if k.ndim != 4:
        raise ValueError(f"k/v must be int8 (NB, bs, KV, hd), got "
                         f"{tuple(k.shape)}")
    nb, bs = k.shape[0], k.shape[1]
    if (block_tables.dtype != torch.int32 or block_tables.ndim != 2
            or block_tables.shape[0] != b):
        raise ValueError(f"block_tables must be (B, MB) int32 with B={b}")
    mb = block_tables.shape[1]
    k_new, v_new = _check("decode_attention_int8_paged", q, k, v, k_scale,
                          v_scale, valid_len, k_new, v_new, nb * bs,
                          extra=(block_tables,))
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    fn = _lib("decode_attention_int8_paged")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    work, counters = _scratch(q, stream)
    err = fn(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
             v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
             valid_len.data_ptr(), block_tables.data_ptr(),
             k_new.data_ptr() if k_new is not None else None,
             v_new.data_ptr() if v_new is not None else None,
             out.data_ptr(), work, counters, b, mb, bs, kvh, g, hd,
             float(sm_scale), stream)
    if err:
        raise RuntimeError(
            f"decode_attention_int8_paged launch failed: CUDA error {err}")
    decode_attention_int8_paged.launches += 1
    return out


decode_attention_int8_paged.launches = 0
counts.register(decode_attention_int8_paged)
