"""Quantized matmuls: the CUDA kernels' wrappers and their plain versions.

``qmatmul_w8a16`` (weight-only int8) launches ``csrc/qmatmul_w8a16.cu``,
the Hopper port of the Pallas TPU kernel
``repro/kernels/qmatmul.py::qmatmul_w8a16``: its GEMV, whose rows do not
depend on M (every decode step; K split across blocks by
:func:`gemv_split_plan`, a function of (K, N) alone), or, through
``qmatmul_w8a16_on_path``, its ``mma.sync`` bf16 tensor-core kernel (the
full-sequence forward).  It
takes CUDA tensors only, checks them, allocates the output, launches on
the current stream and raises if the launch was refused.  Each launch adds
one to ``qmatmul_w8a16.launches`` and to its path's count in
``qmatmul_w8a16.launches_by_path`` (``kernels/counts.py``: a captured
step adds its capture's counts on every replay).

``qmatmul_w8a16_ref`` is the plain PyTorch version of the same function
(the port of ``repro/kernels/ref.py::qmatmul_w8a16_ref``).  It computes
each row on its own, as a broadcast multiply and sum, so a row's result
does not depend on how many rows are in the batch — a plain CPU
``x @ w`` does not have that property.  Each call adds one to
``qmatmul_w8a16_ref.calls``.

``qmatmul_w8a8`` (int8 activations with one scale per tensor, int8
weights, int32 accumulation) launches ``csrc/qmatmul_w8a8.cu``, the port
of ``repro/kernels/qmatmul.py::qmatmul_w8a8``: its GEMV for a decode
tick's few rows (K split across blocks by :func:`w8a8_split_plan`, a
function of (K, N) alone), its ``mma.sync`` tensor-core kernel for a
prefill's many (``w8a8_path``), with identical bits either way.  Each
launch adds one to ``qmatmul_w8a8.launches``.  Its plain version
``qmatmul_w8a8_ref`` (the port of ``ref.py::qmatmul_w8a8_ref``) sums each
row's integer products exactly and drains them in the reference's order;
each call adds one to ``qmatmul_w8a8_ref.calls``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, counts, scratch

ACTIVATIONS = ("none", "relu", "gelu", "silu", "tanh", "sigmoid")
_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's activations; ``gelu`` is the tanh approximation,
    as ``jax.nn.gelu`` defaults to."""
    if activation == "none":
        return y
    if activation == "relu":
        return torch.clamp_min(y, 0.0)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return y * torch.sigmoid(y)
    if activation == "tanh":
        return torch.tanh(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    raise ValueError(f"unknown activation {activation!r}")


def qmatmul_w8a16_ref(x: torch.Tensor, w: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      activation: str = "none",
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """fp acts (M, K) x dequantized int8 weights (K, N), f32 accumulate,
    one row at a time."""
    qmatmul_w8a16_ref.calls += 1
    w_fp = w.float() * w_scale.reshape(1, -1).float()
    xf = x.float()
    acc = torch.empty((xf.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(xf.shape[0]):
        acc[i] = (xf[i][:, None] * w_fp).sum(0)
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return activate(acc, activation).to(out_dtype)


qmatmul_w8a16_ref.calls = 0


def qmatmul_w8a8_ref(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     activation: str = "none",
                     out_dtype=torch.float32) -> torch.Tensor:
    """int8 acts (M, K) x int8 weights (K, N): exact integer sums, one row
    at a time, then ``(float(acc) * x_scale) * w_scale[col]``, ``+ bias``
    and the activation in f32."""
    qmatmul_w8a8_ref.calls += 1
    wi = w.int()
    acc = torch.empty((x.shape[0], w.shape[1]), dtype=torch.int64,
                      device=x.device)
    for i in range(x.shape[0]):
        acc[i] = (x[i].int()[:, None] * wi).sum(0)
    out = acc.float() * x_scale.float() * w_scale.reshape(1, -1).float()
    if bias is not None:
        out = out + bias.reshape(1, -1).float()
    return activate(out, activation).to(out_dtype)


qmatmul_w8a8_ref.calls = 0


# The W8A16 wrapper's two kernels: the GEMV, for every launch whose row
# bits must not depend on the path (the decode step, at any M), and
# mma.sync on the bf16 tensor cores, for the full-sequence forward.  Unlike
# W8A8's integer sums, the two add f32 products in other orders, so the
# choice is made by the caller (``QuantMode.w8a16_path``), never by M.
W8A16_PATHS = ("gemv", "mma")


# The GEMVs' split plans.  A block owns BN output columns (a strip) and one
# range of K.  Three blocks fit on an SM at once (each kernel's launch
# bounds), so a launch of TARGET_BLOCKS = 3 x 132 blocks fills the card in
# one wave with equal work per SM: a projection gets as many splits of K as
# its strips leave room for in that wave (none where the strips alone fill
# it), each at least MIN_ROWS rows and at most MAX_SPLITS of them (the last
# block to arrive adds them all).  The plan is a function of (K, N) alone --
# never of M -- so a row's bits do not depend on how many rows are in the
# launch.
GEMV_BN = 64               # csrc/qmatmul_w8a16.cu: BN
GEMV_G = 8                 # rows of a split are a multiple of this
GEMV_MT = 8                # csrc/qmatmul_w8a16.cu: MT (rows of x per block)
GEMV_MIN_ROWS = 64
GEMV_MAX_SPLITS = 64
GEMV_TARGET_BLOCKS = 3 * 132
# qmatmul_w8a8's GEMV: the same plan for its own strip and row group
W8A8_BN = 64               # csrc/qmatmul_w8a8.cu: BN
W8A8_G = 32                # one m16n8k32 k step; K % 16 == 0 ends the last
W8A8_MR = 16               # csrc/qmatmul_w8a8.cu: MR (rows of x per block)


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """``splits`` ranges of ``split_rows`` rows of K (the last one shorter)
    for each of ``strips`` column strips."""
    k: int
    n: int
    strips: int
    splits: int
    split_rows: int

    @property
    def ranges(self):
        """The K ranges, in the order their partial sums are added."""
        return [(s * self.split_rows, min(self.k, (s + 1) * self.split_rows))
                for s in range(self.splits)]


def _split_plan(k: int, n: int, bn: int, g: int) -> GemvPlan:
    strips = -(-n // bn)
    splits = max(1, min(GEMV_TARGET_BLOCKS // strips, k // GEMV_MIN_ROWS,
                        GEMV_MAX_SPLITS))
    rows = -(-k // splits)
    rows += -rows % g
    return GemvPlan(k, n, strips, -(-k // rows), rows)


@functools.lru_cache(maxsize=None)
def gemv_split_plan(k: int, n: int) -> GemvPlan:
    """The W8A16 GEMV's split of K for a (K, N) weight."""
    if k <= 0 or n <= 0 or k % GEMV_G or n % 4:
        raise ValueError(f"the GEMV needs K % {GEMV_G} == 0 and N % 4 == 0, "
                         f"got K={k} N={n}")
    return _split_plan(k, n, GEMV_BN, GEMV_G)


@functools.lru_cache(maxsize=None)
def w8a8_split_plan(k: int, n: int) -> GemvPlan:
    """``qmatmul_w8a8``'s GEMV's split of K for a (K, N) weight: ranges of
    a multiple of ``W8A8_G`` rows (the last ends at K)."""
    if k <= 0 or n <= 0 or k % 16 or n % 4:
        raise ValueError(f"the W8A8 GEMV needs K % 16 == 0 and N % 4 == 0, "
                         f"got K={k} N={n}")
    return _split_plan(k, n, W8A8_BN, W8A8_G)


def _launch(plan: GemvPlan, m: int, slab: int):
    if plan.splits == 1:
        return plan, 0, 0
    return plan, plan.splits * m * plan.n, -(-m // slab) * plan.strips


@functools.lru_cache(maxsize=None)
def gemv_launch(m: int, k: int, n: int):
    """(plan, workspace f32 elements, counters) of one GEMV launch of m
    rows: the plan does not depend on m, the scratch does (none for one
    split)."""
    return _launch(gemv_split_plan(k, n), m, GEMV_MT)


@functools.lru_cache(maxsize=None)
def w8a8_launch(m: int, k: int, n: int):
    """(plan, workspace int32 elements, counters) of one launch of
    ``qmatmul_w8a8``'s GEMV of m rows, as :func:`gemv_launch`."""
    return _launch(w8a8_split_plan(k, n), m, W8A8_MR)


@functools.lru_cache(maxsize=None)
def _lib():
    """The w8a16 kernels' C entry points, built and bound once per
    process: ``{path: fn}``."""
    lib = _build.load("qmatmul_w8a16")
    gemv, mma = lib.qmatmul_w8a16, lib.qmatmul_w8a16_mma
    gemv.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    mma.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    gemv.restype = mma.restype = ctypes.c_int
    return {"gemv": gemv, "mma": mma}


def qmatmul_w8a16(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  activation: str = "none",
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """act((x @ dequant(w)) + bias) on the card, through the GEMV.

    x: (M, K) bf16/f32 with K % 8 == 0; w: (K, N) int8 with N % 4 == 0;
    w_scale: N f32 values; bias: (N,) f32 or None; out: (M, N)
    ``out_dtype`` (bf16/f32).  All CUDA tensors, contiguous, on one
    device."""
    return qmatmul_w8a16_on_path("gemv", x, w, w_scale, bias,
                                 activation=activation, out_dtype=out_dtype)


def qmatmul_w8a16_on_path(path: str, x: torch.Tensor, w: torch.Tensor,
                          w_scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          activation: str = "none",
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`qmatmul_w8a16` through the named kernel (one of
    ``W8A16_PATHS``); ``"mma"`` takes bf16 x only.  Each launch adds one
    to ``qmatmul_w8a16.launches`` and to
    ``qmatmul_w8a16.launches_by_path[path]``."""
    if path not in W8A16_PATHS:
        raise ValueError(f"unknown path {path!r}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if path == "mma" and x.dtype != torch.bfloat16:
        raise ValueError(f"the mma path takes bf16 x, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("qmatmul_w8a16 launches a CUDA kernel: x must be a "
                         "CUDA tensor (CPU tensors go to qmatmul_w8a16_ref)")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x{tuple(x.shape)} @ w{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in _FLOAT_TYPES or out_dtype not in _FLOAT_TYPES:
        raise ValueError(f"x {x.dtype} / out {out_dtype} must be f32 or bf16")
    if w.dtype != torch.int8 or n % 4 or k % 8:
        raise ValueError(f"w must be int8 with K % 8 == 0 and N % 4 == 0, "
                         f"got {w.dtype} K={k} N={n}")
    if w_scale.dtype != torch.float32 or w_scale.numel() != n:
        raise ValueError("w_scale must hold N f32 values")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.numel() != n):
        raise ValueError("bias must hold N f32 values")
    tensors = [x, w, w_scale] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("qmatmul_w8a16 needs contiguous tensors on "
                             "x's device")
    if w.data_ptr() % 4 or x.data_ptr() % 16:
        raise ValueError("w must be 4-byte and x 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    fn = _lib()[path]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias_ptr = bias.data_ptr() if bias is not None else None
    out_bf16 = int(out_dtype == torch.bfloat16)
    act = ACTIVATIONS.index(activation)
    if path == "gemv":
        plan, work_elems, n_counters = gemv_launch(m, k, n)
        work = counters = None
        if plan.splits > 1:
            work, counters = scratch.get(x.device, stream, work_elems,
                                         n_counters)
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
                 w_scale.data_ptr(), bias_ptr, out.data_ptr(), out_bf16, m,
                 k, n, act, plan.splits, plan.split_rows, work, counters,
                 stream)
    else:
        err = fn(x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), bias_ptr,
                 out.data_ptr(), out_bf16, m, k, n, act, stream)
    if err:
        raise RuntimeError(f"qmatmul_w8a16 ({path}) launch failed: CUDA "
                           f"error {err}")
    qmatmul_w8a16.launches += 1
    qmatmul_w8a16.launches_by_path[path] += 1
    return out


qmatmul_w8a16.launches = 0
qmatmul_w8a16.launches_by_path = dict.fromkeys(W8A16_PATHS, 0)
counts.register(qmatmul_w8a16)


# The W8A8 wrapper's two kernels: rows up to W8A8_GEMV_MAX_ROWS go to the
# GEMV, which reads w once per 16 rows (a decode tick's 8 or 16: once);
# more rows (a prefill's) go to the mma.sync kernel's 64 x 128 tiles.  The
# value is set from chip_smoke.py's times of both at M = 8, 16, 32, 64, 128
# and 512, summed over a tick's projections (PERF.md): the GEMV was faster
# up to 64 rows, the mma.sync kernel from 128 on.  Integer sums are exact
# and both kernels drain through one function, so the choice decides speed
# only: a row's bits never depend on M or on the path.
W8A8_PATHS = ("gemv", "mma")
W8A8_GEMV_MAX_ROWS = 64


def w8a8_path(m: int) -> str:
    """The kernel ``qmatmul_w8a8`` launches for ``m`` rows."""
    return "gemv" if m <= W8A8_GEMV_MAX_ROWS else "mma"


@functools.lru_cache(maxsize=None)
def _lib_w8a8():
    """The w8a8 kernels' C entry point, built and bound once per process."""
    lib = _build.load("qmatmul_w8a8")
    fn = lib.qmatmul_w8a8
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qmatmul_w8a8(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 *, activation: str = "none",
                 out_dtype=torch.float32) -> torch.Tensor:
    """act(float(x @ w) * x_scale * w_scale[col] + bias) on the card, with
    int32 accumulation, through the kernel :func:`w8a8_path` picks.

    x: (M, K) int8 with K % 16 == 0; w: (K, N) int8 with N % 4 == 0;
    x_scale: one f32 value (a device scalar); w_scale: N f32 values;
    bias: (N,) f32 or None; out: (M, N) ``out_dtype`` (bf16/f32).  All
    CUDA tensors, contiguous, on one device."""
    return qmatmul_w8a8_on_path(w8a8_path(x.shape[0]), x, w, x_scale,
                                w_scale, bias, activation=activation,
                                out_dtype=out_dtype)


def qmatmul_w8a8_on_path(path: str, x: torch.Tensor, w: torch.Tensor,
                         x_scale: torch.Tensor, w_scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         activation: str = "none",
                         out_dtype=torch.float32) -> torch.Tensor:
    """:func:`qmatmul_w8a8` through the named kernel (one of
    ``W8A8_PATHS``) whatever M is: for the measurements and tests that
    hold the two kernels against each other.  Counts as a launch of
    ``qmatmul_w8a8``."""
    if path not in W8A8_PATHS:
        raise ValueError(f"unknown path {path!r}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if not x.is_cuda:
        raise ValueError("qmatmul_w8a8 launches a CUDA kernel: x must be a "
                         "CUDA tensor (CPU tensors go to qmatmul_w8a8_ref)")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x{tuple(x.shape)} @ w{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if out_dtype not in _FLOAT_TYPES:
        raise ValueError(f"out {out_dtype} must be f32 or bf16")
    if x.dtype != torch.int8 or w.dtype != torch.int8 or n % 4 or k % 16:
        raise ValueError(f"x and w must be int8 with K % 16 == 0 and "
                         f"N % 4 == 0, got {x.dtype} @ {w.dtype} K={k} N={n}")
    if x_scale.dtype != torch.float32 or x_scale.numel() != 1:
        raise ValueError("x_scale must be one f32 value")
    if w_scale.dtype != torch.float32 or w_scale.numel() != n:
        raise ValueError("w_scale must hold N f32 values")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.numel() != n):
        raise ValueError("bias must hold N f32 values")
    tensors = [x, w, x_scale, w_scale] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("qmatmul_w8a8 needs contiguous tensors on x's "
                             "device")
    if w.data_ptr() % 4 or x.data_ptr() % 16:
        raise ValueError("w must be 4-byte and x 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    fn = _lib_w8a8()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    splits = split_rows = 0
    work = counters = None
    if path == "gemv":
        plan, work_elems, n_counters = w8a8_launch(m, k, n)
        splits, split_rows = plan.splits, plan.split_rows
        if splits > 1:
            work, counters = scratch.get(x.device, stream, work_elems,
                                         n_counters)
    err = fn(x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
             w_scale.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             out.data_ptr(), int(out_dtype == torch.bfloat16), m, k, n,
             ACTIVATIONS.index(activation), int(path == "mma"), splits,
             split_rows, work, counters, stream)
    if err:
        raise RuntimeError(f"qmatmul_w8a8 ({path}) launch failed: CUDA "
                           f"error {err}")
    qmatmul_w8a8.launches += 1
    return out


qmatmul_w8a8.launches = 0
counts.register(qmatmul_w8a8)
