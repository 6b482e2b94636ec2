"""Params of the JAX package, as numpy, turned into the port's params.

``params_from_numpy(tree)`` takes the reference's param tree with every
leaf converted to numpy — a nested dict whose ``QTensor`` leaves are given
as ``(values, scale)`` tuples — and returns the port's tree: the same
dicts, with each stacked layer subtree (leading L axis: ``layers``,
encdec's ``enc_layers`` and ``dec_layers``, or the hybrid's ``groups`` of
(rec0, rec1, attn) and ``leftover`` blocks) split into a list of
per-layer dicts and each ``(values, scale)`` pair made a port
``QTensor``.  No JAX is imported: the JAX -> numpy step belongs to the
caller (the tests do it).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import DeviceLike, resolve_device


def _leaf(x, device) -> Any:
    if isinstance(x, tuple):
        values, scale = x
        return QTensor(values=_leaf(values, device), scale=_leaf(scale, device))
    return torch.tensor(np.asarray(x), device=device)


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    return _leaf(node, device)


def _layer(node, i: int):
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    if isinstance(node, QTensor):
        return QTensor(values=node.values[i].contiguous(),
                       scale=node.scale[i].contiguous(), bits=node.bits)
    return node[i].contiguous()


def _depth(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return (node.values if isinstance(node, QTensor) else node).shape[0]


# the subtrees the reference stacks on a leading layer axis
STACKED = ("layers", "enc_layers", "dec_layers", "groups", "leftover")


def params_from_numpy(tree: dict, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    params = _convert(tree, device)
    for name in STACKED:
        if name in params:
            stacked = params[name]
            params[name] = [_layer(stacked, i)
                            for i in range(_depth(stacked))]
    return params
