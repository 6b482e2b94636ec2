"""Quantization-aware linear layers.

Every matmul of the port's models goes through :func:`linear`, so
post-training quantization (``quant.quantize_tree``) switches a model from
the bf16 path to the paper's int8 serving path:

- fp weight (tensor)          -> plain ``torch.matmul``, bf16 inputs, f32
                                 accumulate (the reference leaves it to XLA)
- QTensor weight, W8A16       -> ``kernels.ops.qmatmul`` (weight-only int8),
                                 through the kernel ``QuantMode.w8a16_path``
                                 names
- QTensor weight, W8A8        -> ``kernels.ops.qmatmul_dynamic`` (int8
                                 activations, one scale per tensor)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops
from repro_torch.kernels.qmatmul import activate


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """Static quantization mode threaded through model apply fns."""
    enabled: bool = False          # weights are QTensors
    act_bits: int = 16             # 8 -> w8a8 integer path, else w8a16
    # the W8A16 kernel on the card (kernels/qmatmul.py W8A16_PATHS), set
    # by the model per caller: models/transformer.py's forward asks for
    # "mma" (tensor cores), its decode_step pins "gemv" (rows independent
    # of the batch, which the engine's parity with its reference needs)
    w8a16_path: str = "gemv"

    @property
    def w8a8(self) -> bool:
        return self.enabled and self.act_bits == 8


FP = QuantMode(enabled=False)
W8A16 = QuantMode(enabled=True, act_bits=16)
W8A8 = QuantMode(enabled=True, act_bits=8)


def linear(params: dict, x: torch.Tensor, *, activation: str = "none",
           mode: QuantMode = FP,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = act(x @ w + b), dispatching on the weight's quantization state.
    The result has ``x``'s dtype."""
    w = params["w"]
    b = params.get("b")
    if isinstance(w, QTensor):
        if mode.w8a8:
            return ops.qmatmul_dynamic(x, w, b, activation=activation,
                                       out_dtype=x.dtype)
        return ops.qmatmul(x, w, b, activation=activation, out_dtype=x.dtype,
                           path=mode.w8a16_path)
    y = torch.matmul(x.to(compute_dtype).float(), w.to(compute_dtype).float())
    if b is not None:
        y = y + b.float()
    return activate(y, activation).to(x.dtype)
