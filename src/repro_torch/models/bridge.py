"""Params of the JAX package, as numpy, turned into the port's params.

``params_from_numpy(tree)`` takes the reference's param tree with every
leaf converted to numpy — a nested dict whose ``QTensor`` leaves are given
as ``(values, scale)`` tuples — and returns the port's tree: the same
dicts, with each stacked layer subtree (leading L axis: ``layers``,
encdec's ``enc_layers`` and ``dec_layers``, or the hybrid's ``groups`` of
(rec0, rec1, attn) and ``leftover`` blocks) split into a list of
per-layer dicts and each ``(values, scale)`` pair made a port
``QTensor``.  The vlm family's tree stacks twice — ``groups.plain``
leads with (n_groups, xattn_every - 1), ``groups.xattn`` with n_groups —
and comes out as ``models/vision.py`` lays it: one flat ``layers`` list,
each group's plain layers then its cross layer, then the ``leftover``
plain layers.  No JAX is imported: the JAX -> numpy step belongs to the
caller (the tests do it).

``opt_state_from_numpy(state)`` carries an optimizer's state across the
same way: the reference's ``AdamWState`` or ``AdafactorState`` with every
leaf numpy (any NamedTuple with those fields) becomes the port's.
AdamW's m, v and master mirror the params, so their stacked layers are
split as ``params_from_numpy`` splits them; Adafactor's moments stay
stacked, the layout the port's Adafactor keeps
(``optim/optimizers.py::adafactor_init``).
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


def _split(stacked) -> list:
    return [_layer(stacked, i) for i in range(_depth(stacked))]


def _vlm_layers(groups: dict, leftover) -> list:
    """The vlm tree's layers in order: each group's plain layers (its
    second stacked axis), then its cross layer; then the leftover ones."""
    layers = []
    for g in range(_depth(groups["xattn"])):
        layers += _split(_layer(groups["plain"], g))
        layers.append(_layer(groups["xattn"], g))
    return layers + (_split(leftover) if leftover is not None else [])


def params_from_numpy(tree: dict, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    params = _convert(tree, device)
    if "plain" in params.get("groups", {}):
        params["layers"] = _vlm_layers(params.pop("groups"),
                                       params.pop("leftover", None))
        return params
    for name in STACKED:
        if name in params:
            params[name] = _split(params[name])
    return params


def opt_state_from_numpy(state, device: DeviceLike = None):
    from repro_torch.optim import AdafactorState, AdamWState
    device = resolve_device(device)
    step = torch.tensor(np.asarray(state.step), dtype=torch.int32,
                        device=device)
    if hasattr(state, "m"):
        def split(tree):
            return None if tree is None else params_from_numpy(tree, device)
        return AdamWState(step, split(state.m), split(state.v),
                          split(state.master))
    return AdafactorState(step, _convert(state.vr, device),
                          _convert(state.vc, device))
