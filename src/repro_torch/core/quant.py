"""Symmetric integer quantization — the TPU paper's numerical contract.

Port of ``repro/core/quant.py``'s inference subset: symmetric int8
quantization per tensor / per channel, the ``QTensor`` record (int values
+ f32 scales) consumed by ``kernels.ops.qmatmul`` and ``core.qlinear``,
its dequantization, post-training quantization of a parameter tree, and
``bits_speed_factor`` (the paper's speed of each operand width, read by
``core/perfmodel.py``).

A 2-D weight is stored padded for the int8 kernels (:func:`pad_weight`):
zero rows up to K rounded to ``KERNEL_K_ALIGN``, zero columns up to N
rounded to ``KERNEL_N_ALIGN`` (scale 1.0), once, where it is quantized or
bridged; the QTensor keeps its logical (K, N) as ``shape``.

Quantization is bitwise equal to the JAX reference as it runs under jit:
the scale is ``max(amax, 1e-8) * f32(1 / qmax)`` (XLA turns the
reference's division by the constant qmax into that multiply), values are
``x / scale`` (a true division, never a multiply by the reciprocal)
rounded half-to-even and clipped to the symmetric range.  ``fake_quant``,
calibration and gradient compression are not ported yet (ROADMAP queue 1,
item 15).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_QUANT_PATH_RE = re.compile(r"(\.w$|(^|\.)table$|experts.*w_(gate|up|down)$)")


def int_bounds(bits: int, signed: bool = True) -> Tuple[int, int]:
    """Inclusive (min, max) representable values for a `bits`-wide integer."""
    if signed:
        return -(2 ** (bits - 1)) + 1, 2 ** (bits - 1) - 1  # symmetric: drop -128
    return 0, 2**bits - 1


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized tensor: int values + float scale(s).

    ``values``  int8 data, shape S.
    ``scale``   f32 scale, broadcastable to S (per-tensor or per-channel).
    ``bits``    nominal bit width.
    ``logical`` the (K, N) of a 2-D weight whose ``values`` and ``scale``
                are padded for the kernels (:func:`pad_weight`), else None.
    Dequantization: ``values.float() * scale``.
    """

    values: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    logical: Optional[Tuple[int, int]] = None

    @property
    def shape(self):
        """The logical shape (the padded storage's is ``values.shape``)."""
        if self.logical is None:
            return self.values.shape
        return torch.Size(self.logical)

    def unpadded(self) -> "QTensor":
        """This tensor without its kernel padding: views of the logical
        rows and columns (itself when it has none)."""
        if self.logical is None:
            return self
        k, n = self.logical
        return QTensor(values=self.values[:k, :n], scale=self.scale[:, :n],
                       bits=self.bits)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        q = self.unpadded()
        return q.values.to(dtype) * q.scale.to(dtype)

    @property
    def nbytes_weights(self) -> int:
        """Bytes of weight-memory traffic to stream this tensor once (the
        logical tensor's, as the reference counts them)."""
        q = self.unpadded()
        return q.values.numel() * self.bits // 8 + q.scale.numel() * 4


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    return q.dequantize(dtype)


# the shapes the int8 kernels take: K % 16 == 0 (qmatmul_w8a8; the W8A16
# GEMV needs 8) and N % 4 == 0 (both)
KERNEL_K_ALIGN = 16
KERNEL_N_ALIGN = 4


def pad_weight(q: QTensor) -> QTensor:
    """A 2-D (K, N) weight with per-column scales, stored for the int8
    kernels at any K and N: zero rows up to K rounded to
    ``KERNEL_K_ALIGN``, zero columns up to N rounded to ``KERNEL_N_ALIGN``
    with scale 1.0, and ``logical`` = (K, N).  Made once, where the weight
    is quantized or bridged, so no call copies it; ``kernels/ops.py``
    zero-pads x's last axis to the stored K and returns the first N
    columns.  Anything else (already padded or aligned, a stack, a table's
    per-row scales) is returned as is."""
    if (q.logical is not None or q.values.ndim != 2
            or tuple(q.scale.shape) != (1, q.values.shape[1])):
        return q
    k, n = q.values.shape
    pk, pn = -k % KERNEL_K_ALIGN, -n % KERNEL_N_ALIGN
    if not (pk or pn):
        return q
    return QTensor(values=F.pad(q.values, (0, pn, 0, pk)),
                   scale=F.pad(q.scale.reshape(1, n), (0, pn), value=1.0),
                   bits=q.bits, logical=(k, n))


def compute_scale(x: torch.Tensor, bits: int = 8, axis=None) -> torch.Tensor:
    """Symmetric scale so that max|x| maps to qmax (reduced over ``axis``,
    kept as size-1 dims; ``None`` is per-tensor)."""
    _, qmax = int_bounds(bits)
    ax = x.abs()
    if axis is None:
        amax = ax.amax()
    else:
        amax = ax.amax(dim=tuple(a % x.ndim for a in axis), keepdim=True)
    amax = torch.clamp_min(amax, 1e-8)     # avoid div-by-zero on dead channels
    # The reference's ``amax / qmax`` runs under jit, where XLA rewrites a
    # division by a constant into a multiply by its f32 reciprocal; do the
    # same to stay bitwise equal.
    return (amax * (1.0 / qmax)).to(torch.float32)


def quantize(x: torch.Tensor, bits: int = 8, axis=None) -> QTensor:
    """Quantize ``x`` symmetrically to ``bits`` ints.

    ``axis`` names the REDUCED axes (as in the reference): ``(0,)`` on a
    (d_in, d_out) weight gives one scale per output column."""
    if isinstance(axis, int):
        axis = (axis,)
    scale = compute_scale(x, bits=bits, axis=axis)
    qmin, qmax = int_bounds(bits)
    rounded = torch.round(x / scale)      # round half to even, as jnp.round
    q = torch.clamp(rounded, qmin, qmax).to(
        torch.int8 if bits <= 8 else torch.int16)
    return QTensor(values=q, scale=scale, bits=bits)


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QTensor:
    """Per-output-channel quantization of a linear weight (..., d_in, d_out):
    only the contraction axis d_in is reduced, so scales are (..., 1, d_out).
    A 2-D weight is stored padded for the kernels (:func:`pad_weight`)."""
    return pad_weight(quantize(w, bits=bits, axis=(w.ndim - 2,)))


def quantize_embedding(w: torch.Tensor, bits: int = 8,
                       row_chunk: Optional[int] = None) -> QTensor:
    """Per-row (per-vocab-entry) quantization for embedding tables: gathers
    dequantize row-wise, and the tied LM head folds scales per output.
    ``row_chunk`` quantizes ``row_chunk`` rows at a time into the result,
    so the f32 temporaries are a chunk's, not the table's; every row
    reduces on its own, so the bits are the same either way."""
    axis = tuple(range(1, w.ndim))
    if row_chunk is None or w.shape[0] <= row_chunk:
        return quantize(w, bits=bits, axis=axis)
    parts = [quantize(w[r:r + row_chunk], bits=bits, axis=axis)
             for r in range(0, w.shape[0], row_chunk)]
    return QTensor(values=torch.cat([p.values for p in parts]),
                   scale=torch.cat([p.scale for p in parts]), bits=bits)


def _default_quant_predicate(path_str: str, leaf) -> bool:
    """Quantize matmul weights only: paths ending '.w' or embedding
    'table's.  Norm scales, biases and positional tables stay fp."""
    if not (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf.is_floating_point()):
        return False
    if "dec_pos" in path_str:
        return False
    return bool(_QUANT_PATH_RE.search(path_str))


def quantize_tree(params, bits: int = 8, min_size: int = 4096,
                  predicate=None, *, prefix: str = "",
                  row_chunk: Optional[int] = None):
    """Post-training quantization of a nested dict/list parameter tree.

    Matmul weights (path allowlist, >= ``min_size`` elements) become
    QTensors; everything else is returned as is.  Path strings join dict
    keys and list indices with '.', so a layer weight reads
    ``layers.3.attn.wq.w``; ``prefix`` is the path of ``params`` inside a
    larger tree (``"layers.3"`` for one layer's subtree), so a subtree
    quantizes as it would inside the whole.  ``predicate(path_str, leaf)
    -> bool`` overrides the allowlist.  ``row_chunk``: embedding tables
    quantize that many rows at a time (:func:`quantize_embedding`)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        path_str = ".".join(path)
        if predicate is not None:
            do_q = predicate(path_str, node)
        else:
            do_q = (_default_quant_predicate(path_str, node)
                    and node.numel() >= min_size)
        if not do_q:
            return node
        if "table" in path_str:
            return quantize_embedding(node, bits=bits, row_chunk=row_chunk)
        return quantize_weight(node, bits=bits)
    return walk(params, tuple(prefix.split(".")) if prefix else ())


def tree_weight_bytes(params) -> int:
    """Total weight-memory bytes of a (possibly quantized) param tree."""
    if isinstance(params, dict):
        return sum(tree_weight_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_weight_bytes(v) for v in params)
    if isinstance(params, QTensor):
        return params.nbytes_weights
    return params.numel() * params.element_size()


def bits_speed_factor(w_bits: int, a_bits: int) -> float:
    """Paper section 2: 8x8 full speed, 8x16 or 16x8 half, 16x16 quarter."""
    f = 1.0
    if w_bits > 8:
        f *= 0.5
    if a_bits > 8:
        f *= 0.5
    return f
